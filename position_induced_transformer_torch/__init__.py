"""position_induced_transformer_torch — the PyTorch and CUDA port of
``position_induced_transformer_tpu``, for NVIDIA Hopper (H100).

The JAX package stays the reference; this package imports nothing from it
and no JAX. Layout and module names mirror the JAX package:

- ``ops``      : position attention (plain PyTorch oracle), distances,
                 locality thresholds, initializers.
- ``kernels``  : hand-written sm_90a CUDA kernels and their wrappers.
- ``models``   : ``PiT`` and the TF-semantics ``PiTTFPointCloud`` as
                 ``nn.Module``s, and the mesh ``Geometry``.
- ``data``     : loaders and synthetic generators.
- ``train``    : benchmark setup, checkpoints, ``Predictor``/``infer`` and
                 the HTTP server.
- ``configs``  : the benchmark configurations.
- ``cli``      : the command line, ``python -m position_induced_transformer_torch``.

Entry points run on CUDA by default and raise when no CUDA device is
present, unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"


def register_benchmark(cfg, setup_fn, overwrite: bool = False):
    """Register a user-defined benchmark, its configuration and its setup,
    in one call: afterwards every entry point takes its name
    (``runner.train``, ``evaluate``, ``infer``, the server, the command
    line with ``--problem-module``). ``setup_fn`` is called as
    ``setup_fn(cfg, data_path, ntrain=, ntest=, device=)``
    (``train.benchmarks.register_setup``). Atomic: when the setup cannot
    be registered, a configuration registered here is taken out again."""
    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.train import benchmarks

    had_config = getattr(cfg, "name", None) in configs.REGISTRY
    configs.register(cfg, overwrite=overwrite)
    try:
        benchmarks.register_setup(cfg.name, setup_fn, overwrite=overwrite)
    except BaseException:
        if not had_config:
            configs.REGISTRY.pop(cfg.name, None)
        raise
    return cfg
