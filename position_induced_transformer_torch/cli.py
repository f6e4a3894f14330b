"""Command line of the port:

    python -m position_induced_transformer_torch train --benchmark burgers
    python -m position_induced_transformer_torch evaluate --benchmark darcy \
        --checkpoint darcy.pt --zssr
    python -m position_induced_transformer_torch benchmarks

The commands are the JAX package's: ``train``, ``evaluate``, ``infer``,
``serve``, ``convert``, ``benchmarks`` and ``describe``, with its options.
They run on the card; ``--device cpu`` runs them on the CPU, and without a
card and without it they raise. ``--model-variant`` (``lite``,
``transformer``, ``selfpit``: the TF family's ablation models) reaches
every command; ``--mesh`` and ``--multihost`` are accepted and raise
``NotImplementedError`` (not ported); the port has no counterpart of ``--fused-mode``, since a CUDA
tensor always runs the hand-written kernels. Data default to the synthetic
generators; ``--data-path`` or ``PIT_REAL_DATA_DIR`` selects real
datasets (``data/catalog.py``). ``convert`` moves checkpoints between the
reference's ``model.pth`` and this package's format.
"""

from __future__ import annotations

import argparse
import json
import sys

_NOT_PORTED = ("mesh", "multihost")


def _add_common(p):
    p.add_argument("--benchmark", required=True, help="benchmark name")
    p.add_argument("--data-path", default=None, help="dataset file/dir")
    p.add_argument("--ntrain", type=int, default=None)
    p.add_argument("--ntest", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument(
        "--device", default="cuda",
        help="torch device to run on: 'cuda' (default; raises without a "
        "card) or 'cpu'",
    )
    p.add_argument(
        "--model-variant", default=None,
        choices=["pit", "lite", "transformer", "selfpit"],
        help="ablation model for TF-family benchmarks (the reference swaps one "
        "constructor line per experiment, tensorflow/*/train.py): 'lite' = "
        "self-attention processor, 'transformer' = all self-attention, "
        "'selfpit' = hybrid dot-product + distance-bias attention",
    )
    p.add_argument("--mesh", default=None, help="multi-device mesh (not ported)")
    p.add_argument(
        "--set", action="append", default=None, metavar="KEY=VALUE",
        dest="overrides",
        help="override any config field, repeatable: e.g. "
        "--set model.hid_dim=128 --set lr=3e-4 --set latent_grid=16,16",
    )
    p.add_argument("--multihost", default=None, help="multi-process cluster (not ported)")
    _add_problem_module(p)


def _add_problem_module(p):
    p.add_argument(
        "--problem-module", action="append", default=None, metavar="MODULE",
        dest="problem_modules",
        help="import this python module (or .py file path) before resolving "
        "the benchmark name; the module registers user-defined benchmarks "
        "with position_induced_transformer_torch.register_benchmark. "
        "Repeatable",
    )


def _load_problem_modules(args):
    """Import the user modules that register benchmarks (their import is
    the registration), before any benchmark name is looked up. A ``.py``
    path runs under a name of its own, so that it shadows no other module;
    a dotted name already imported is reloaded, so a second ``main()`` in
    one process registers again; a module that fails is not cached."""
    import importlib
    import importlib.util
    import os

    for mod in getattr(args, "problem_modules", None) or ():
        if mod.endswith(".py") or os.path.sep in mod:
            path = os.path.abspath(mod)
            name = "_pit_torch_problem_" + os.path.splitext(os.path.basename(path))[0]
            spec = importlib.util.spec_from_file_location(name, path)
            if spec is None or spec.loader is None:
                raise ValueError(f"cannot import problem module {mod!r}")
            module = importlib.util.module_from_spec(spec)
            sys.modules[name] = module
            try:
                spec.loader.exec_module(module)
            except BaseException:
                sys.modules.pop(name, None)
                raise
        elif mod in sys.modules:
            importlib.reload(sys.modules[mod])
        else:
            importlib.import_module(mod)


def _refuse_not_ported(args):
    for opt in _NOT_PORTED:
        value = getattr(args, opt, None)
        if value:
            raise NotImplementedError(f"--{opt.replace('_', '-')} {value!r} is not ported yet")


def _convert(args):
    """Checkpoints between the reference's ``model.pth`` and this
    package's format: ``--from-torch X --to Y`` imports (``--benchmark``
    names the checkpoint's benchmark), ``--from Y --to-torch X`` exports.
    With ``--benchmark`` the parameter names and shapes are held against
    that benchmark's model."""
    from position_induced_transformer_torch.configs import get
    from position_induced_transformer_torch.train import benchmarks
    from position_induced_transformer_torch.train import checkpoint as ckpt
    from position_induced_transformer_torch.utils import torch_compat

    def validate(state):
        if not args.benchmark:
            return
        cfg = get(args.benchmark)
        problem = benchmarks.setup(
            cfg, None, ntrain=min(cfg.ntrain, 2 * cfg.batch_size),
            ntest=min(cfg.ntest, cfg.batch_size), device=args.device,
        )
        want = {(k, tuple(v.shape)) for k, v in problem.model.state_dict().items()}
        got = {(k, tuple(v.shape)) for k, v in state.items()}
        if want != got:
            missing = sorted(str(p) for p in want - got)
            extra = sorted(str(p) for p in got - want)
            raise ValueError(
                f"converted parameters do not match benchmark "
                f"{args.benchmark!r}: missing {missing or 'none'}, "
                f"unexpected/mis-shaped {extra or 'none'}"
            )

    if args.from_torch and args.dst:
        if not args.benchmark:
            raise ValueError(
                "convert --from-torch needs --benchmark: a checkpoint of this "
                "package names its benchmark"
            )
        state = torch_compat.load_torch_checkpoint(args.from_torch)
        validate(state)
        out = ckpt.save(args.dst, state, get(args.benchmark).name)
        print(json.dumps({"imported": args.from_torch, "checkpoint": out}))
        return 0
    if args.src and args.to_torch:
        state = ckpt.restore(args.src)["state_dict"]
        validate(state)
        torch_compat.save_torch_checkpoint(args.to_torch, state)
        print(json.dumps({"exported": args.to_torch, "n_tensors": len(state)}))
        return 0
    raise ValueError(
        "convert needs either --from-torch + --to (import) or "
        "--from + --to-torch (export)"
    )


def _resolve_data_path(args):
    """The data path: an explicit ``--data-path`` that is a catalog root
    resolves to the benchmark's file or directory inside it, any other is
    passed through; without one, a ``PIT_REAL_DATA_DIR`` holding the
    benchmark's files selects them; otherwise None (synthetic data)."""
    import os

    from position_induced_transformer_torch.data import catalog

    bench = getattr(args, "benchmark", None)
    dp = getattr(args, "data_path", None)
    if dp is not None:
        if bench and os.path.isdir(dp):
            resolved = catalog.data_path_for(bench, dp)
            if resolved is not None and resolved != dp:
                return resolved
        return dp
    root = catalog.real_data_root()
    if bench and root:
        resolved = catalog.data_path_for(bench, root)
        if resolved is not None:
            print(f"[data] PIT_REAL_DATA_DIR: using real {bench} dataset ({resolved})",
                  file=sys.stderr)
            return resolved
    return None


def _parser():
    parser = argparse.ArgumentParser(prog="position_induced_transformer_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p_train = sub.add_parser("train", help="train a benchmark")
    _add_common(p_train)
    p_train.add_argument("--epochs", type=int, default=None)
    p_train.add_argument("--checkpoint", default=None, help="save path")
    p_train.add_argument("--log", default=None, help="JSONL metrics path")
    p_train.add_argument("--save-pred", default=None, help="save test predictions (.mat)")
    p_train.add_argument(
        "--profile", default=None,
        help="write a torch.profiler Chrome trace of one epoch into this dir",
    )
    p_train.add_argument("--history-csv", default=None, help="write training history CSV")
    p_train.add_argument(
        "--history-plot", default=None, help="write log-scale history PNG (needs matplotlib)"
    )
    p_train.add_argument(
        "--debug-nans", action="store_true",
        help="raise on the first non-finite loss or gradient of a step",
    )
    p_train.add_argument(
        "--plots", default=None,
        help="write prediction figures to this dir (needs matplotlib)",
    )
    p_train.add_argument(
        "--resume", default=None,
        help="resume training from a checkpoint (weights + optimizer + step)",
    )
    p_train.add_argument(
        "--checkpoint-every", type=int, default=None,
        help="also write the checkpoint every N epochs",
    )
    p_train.add_argument(
        "--grad-accum", type=int, default=1,
        help="accumulate gradients over N sequential microbatches per step",
    )
    p_train.add_argument(
        "--sync-every", type=int, default=1,
        help="read metrics back from the device every N epochs (0 = only at the end)",
    )

    p_eval = sub.add_parser("evaluate", help="evaluate a checkpoint")
    _add_common(p_eval)
    p_eval.add_argument("--checkpoint", required=True)
    p_eval.add_argument(
        "--zssr", action="store_true",
        help="Darcy zero-shot super-resolution at full 421^2 resolution",
    )
    p_eval.add_argument(
        "--zssr-downsampling", type=int, default=1,
        help="downsampling factor of the ZSSR mesh (1 = full 421^2)",
    )
    p_eval.add_argument("--save-pred", default=None)
    p_eval.add_argument(
        "--plots", default=None,
        help="write prediction figures to this dir (needs matplotlib)",
    )
    p_eval.add_argument(
        "--shuffle-ablation", action="store_true",
        help="also report test rel-L2 with the input functions shuffled "
        "across samples",
    )

    p_inf = sub.add_parser(
        "infer", help="run a checkpoint on user-supplied inputs"
    )
    _add_common(p_inf)
    p_inf.add_argument("--checkpoint", required=True)
    p_inf.add_argument(
        "--input", required=True,
        help="input batch file (.npy, or .mat/.h5 with --input-key) of raw "
        "values laid out like the benchmark's inputs",
    )
    p_inf.add_argument("--input-key", default="x",
                       help="variable name inside a .mat/.h5 input file")
    p_inf.add_argument("--output", default=None,
                       help="write predictions to this path (.npy or .mat)")
    p_inf.add_argument("--batch-size", type=int, default=None)
    p_inf.add_argument(
        "--rollout-steps", type=int, default=None,
        help="autoregressive rollout horizon (default: the benchmark's; 0 "
        "disables it; a one-step model whose output is its next input "
        "rolls out too)",
    )
    p_inf.add_argument(
        "--zssr-downsampling", type=int, default=None,
        help="run at another mesh resolution (a setup with 'downsampling', "
        "e.g. darcy: 1 = full 421^2)",
    )

    p_srv = sub.add_parser(
        "serve", help="serve a checkpoint over HTTP (POST /predict, GET /health, GET /info)"
    )
    _add_common(p_srv)
    p_srv.add_argument("--checkpoint", required=True)
    p_srv.add_argument("--host", default="127.0.0.1")
    p_srv.add_argument("--port", type=int, default=8765)
    p_srv.add_argument(
        "--no-warmup", action="store_true",
        help="skip the startup batch at the serving batch size",
    )

    p_conv = sub.add_parser(
        "convert", help="convert checkpoints to/from the reference's torch .pth format"
    )
    p_conv.add_argument(
        "--benchmark", default=None,
        help="the benchmark whose model the parameters must fit (needed to import)",
    )
    p_conv.add_argument(
        "--from-torch", default=None,
        help="reference model.pth to import ({'model_state': ...} or a bare state dict)",
    )
    p_conv.add_argument("--to-torch", default=None,
                        help="write a reference-compatible model.pth here")
    p_conv.add_argument("--from", dest="src", default=None, help="our checkpoint to export")
    p_conv.add_argument("--to", dest="dst", default=None,
                        help="write the imported checkpoint here")
    _add_problem_module(p_conv)
    p_conv.add_argument("--device", default="cuda",
                        help="device of the model built to validate against")

    p_bench = sub.add_parser("benchmarks", help="list available benchmarks")
    _add_problem_module(p_bench)

    p_desc = sub.add_parser("describe", help="print a model/problem summary for a benchmark")
    _add_common(p_desc)
    return parser


def main(argv=None):
    args = _parser().parse_args(argv)
    if getattr(args, "data_path", None) is not None or getattr(args, "benchmark", None):
        args.data_path = _resolve_data_path(args)
    _refuse_not_ported(args)
    _load_problem_modules(args)

    if args.command == "convert":
        return _convert(args)

    if args.command == "benchmarks":
        from position_induced_transformer_torch.configs import REGISTRY

        for name, cfg in sorted(REGISTRY.items()):
            m = cfg.model
            print(
                f"{name:12s} hid={m.hid_dim:<4d} heads={m.n_head} "
                f"blocks={m.n_blocks} metric={cfg.metric:10s} "
                f"epochs={cfg.epochs}"
            )
        return 0

    from position_induced_transformer_torch.configs import apply_overrides, get

    # --set resolves the name to a config object once; every entry point
    # takes either form
    if args.overrides:
        args.benchmark = apply_overrides(get(args.benchmark), args.overrides)
    cfg = get(args.benchmark) if isinstance(args.benchmark, str) else args.benchmark
    if args.model_variant:
        import dataclasses

        cfg = dataclasses.replace(cfg, model_variant=args.model_variant)

    if args.command == "describe":
        import numpy as np

        from position_induced_transformer_torch.train import benchmarks

        problem = benchmarks.setup(
            cfg, args.data_path,
            ntrain=args.ntrain or min(cfg.ntrain, 4 * cfg.batch_size),
            ntest=args.ntest or min(cfg.ntest, cfg.batch_size), device=args.device,
        )
        info = {
            "benchmark": cfg.name,
            "model": type(problem.model).__name__,
            "params": sum(p.numel() for p in problem.model.parameters()),
            "metric": cfg.metric,
            "loss": f"rel-L{cfg.loss_p}",
            "rollout_steps": cfg.rollout_steps,
            "train_shape": {k: list(np.shape(v)) for k, v in problem.train_data.items()},
        }
        print(json.dumps(info, indent=1))
        return 0

    if args.command == "train":
        from position_induced_transformer_torch.train import runner
        from position_induced_transformer_torch.utils import profiling

        was = profiling.debug_nans_enabled()
        profiling.debug_nans(args.debug_nans or was)
        try:
            problem, state, history = runner.train(
                cfg,
                data_path=args.data_path,
                epochs=args.epochs,
                ntrain=args.ntrain,
                ntest=args.ntest,
                seed=args.seed,
                log_path=args.log,
                checkpoint_path=args.checkpoint,
                profile_dir=args.profile,
                history_csv=args.history_csv,
                history_plot=args.history_plot,
                resume_from=args.resume,
                checkpoint_every=args.checkpoint_every,
                sync_every=args.sync_every,
                grad_accum=args.grad_accum,
                device=args.device,
            )
        finally:
            profiling.debug_nans(was)
        print(json.dumps({"final": history[-1] if history else {}}))
        if args.save_pred or args.plots:
            import numpy as np

            pred = runner.predict(problem)
            if args.save_pred:
                from scipy.io import savemat

                savemat(args.save_pred, {
                    "pred": pred,
                    "trueX": np.asarray(problem.test_data["x"]),
                    "trueY": np.asarray(problem.test_data["y"]),
                })
            if args.plots:
                from position_induced_transformer_torch.train.plots import save_benchmark_plots

                save_benchmark_plots(problem, pred, args.plots)
        return 0

    if args.command == "infer":
        from position_induced_transformer_torch.train import evaluate

        setup_kwargs = None
        if args.zssr_downsampling is not None:
            setup_kwargs = {"downsampling": args.zssr_downsampling}
        result = evaluate.infer(
            cfg,
            checkpoint_path=args.checkpoint,
            input_path=args.input,
            input_key=args.input_key,
            output_path=args.output,
            batch_size=args.batch_size,
            rollout_steps=args.rollout_steps,
            data_path=args.data_path,
            setup_kwargs=setup_kwargs,
            device=args.device,
        )
        print(json.dumps(result))
        return 0

    if args.command == "serve":
        from position_induced_transformer_torch.train.serve import serve

        serve(
            cfg,
            checkpoint_path=args.checkpoint,
            host=args.host,
            port=args.port,
            warmup=not args.no_warmup,
            data_path=args.data_path,
            device=args.device,
        )
        return 0

    if args.command == "evaluate":
        from position_induced_transformer_torch.train import evaluate

        result = evaluate.evaluate(
            cfg,
            checkpoint_path=args.checkpoint,
            data_path=args.data_path,
            ntest=args.ntest,
            zssr=args.zssr,
            zssr_downsampling=args.zssr_downsampling,
            save_pred=args.save_pred,
            plots_dir=args.plots,
            shuffle_ablation=args.shuffle_ablation,
            device=args.device,
        )
        print(json.dumps(result))
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
