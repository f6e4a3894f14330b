"""PiT models (the torch-semantics family and the TF-semantics fixed-mesh
and point-cloud models) and the mesh geometry."""

from position_induced_transformer_torch.models.baselines import (  # noqa: F401
    LiteTransformer,
    SelfPiT,
    Transformer,
)
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
    MultiHeadPosAtt,
    MultiHeadPosAttBatched,
    MultiHeadSelfAtt,
    PiTTF,
    PiTTFPointCloud,
    SelfMultiHeadPosAtt,
    TFDense,
    TFGeometry,
    TFMlp,
    pairwise_dist_half,
    pairwise_dist_periodic_1d,
    pairwise_dist_periodic_2d,
    tf_precompute_thresholds,
)
