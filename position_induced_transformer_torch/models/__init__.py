"""PiT model (torch-semantics family) and its mesh geometry."""

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
