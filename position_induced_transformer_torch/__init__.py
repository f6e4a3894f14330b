"""position_induced_transformer_torch — the PyTorch and CUDA port of
``position_induced_transformer_tpu``, for NVIDIA Hopper (H100).

The JAX package stays the reference; this package imports nothing from it
and no JAX. Layout and module names mirror the JAX package:

- ``ops``      : position attention (plain PyTorch oracle), distances,
                 locality thresholds, initializers.
- ``kernels``  : hand-written sm_90a CUDA kernels and their wrappers.
- ``models``   : ``PiT`` as ``nn.Module``s and its mesh ``Geometry``.
- ``data``     : loaders and synthetic generators.
- ``train``    : benchmark setup, checkpoints, ``Predictor``/``infer`` and
                 the HTTP server.
- ``configs``  : the benchmark configurations.

Entry points run on CUDA by default and raise when no CUDA device is
present, unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
