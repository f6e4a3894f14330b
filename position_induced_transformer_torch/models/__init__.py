"""PiT models (the torch-semantics family and the TF-semantics point-cloud
model) and the mesh geometry."""

from position_induced_transformer_torch.models.geometry import (  # noqa: F401
    Geometry,
    build_geometry,
)
from position_induced_transformer_torch.models.pit import (  # noqa: F401
    KaimingMLP,
    PiT,
    PosAtt,
    PosAttCross,
    TorchLinear,
)
from position_induced_transformer_torch.models.pit_tf import (  # noqa: F401
    MultiHeadPosAttBatched,
    PiTTFPointCloud,
    TFDense,
    TFMlp,
    pairwise_dist_half,
)
