#!/usr/bin/env python3
"""How far the JAX package and the PyTorch port drift apart over Adam steps
of vorticity's backpropagation through rollouts, on the CPU.

Both sides start from the same JAX-initialised weights and take the same
batches; each step backpropagates through ``rollout_steps`` chained
forwards. Prints the largest relative loss difference and, per weight
tensor, the largest absolute difference and its ratio to the one-step
training bound (2e-5 + 5e-3 |w|) that the port's other training
comparisons use. The grid comes from a trajectory file the script writes
with the synthetic generator, since the loaders take the grid from the
data.

    JAX_PLATFORMS=cpu python scripts/torch_bptt_gap.py --hid 128 --blocks 4 \\
        --grid 64 --latent 16 --batch 8 --steps 16
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hid", type=int, default=128)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--latent", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=16, help="Adam steps")
    ap.add_argument("--rollout", type=int, default=20, help="rollout steps a training step")
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    import jax.numpy as jnp
    import numpy as np
    import optax
    import torch
    from scipy.io import savemat

    from position_induced_transformer_torch import configs as t_configs
    from position_induced_transformer_torch.data import synthetic
    from position_induced_transformer_torch.train import benchmarks as t_bench
    from position_induced_transformer_torch.train import loop as t_loop
    from position_induced_transformer_torch.utils.torch_compat import flax_params_to_state_dict
    from position_induced_transformer_tpu import configs as j_configs
    from position_induced_transformer_tpu.train import benchmarks as j_bench
    from position_induced_transformer_tpu.train import loop as j_loop

    torch.set_num_threads(args.threads)
    B, n_train = args.batch, 4 * args.batch
    memory = t_configs.VORTICITY.memory
    path = os.path.join(tempfile.mkdtemp(), "trajectories.mat")
    savemat(path, {"u": synthetic.vorticity(n=n_train + 2, s=args.grid,
                                            frames=memory + args.rollout, seed=3)})

    def narrow(cfg):
        return dataclasses.replace(
            cfg, grid=(args.grid, args.grid), latent_grid=(args.latent, args.latent), batch_size=B,
            rollout_steps=args.rollout,
            model=dataclasses.replace(cfg.model, hid_dim=args.hid, n_blocks=args.blocks))

    jp = j_bench.setup_vorticity(narrow(j_configs.VORTICITY), path, ntrain=n_train, ntest=2)
    tp = t_bench.setup(narrow(t_configs.VORTICITY), path, ntrain=n_train, ntest=2, device="cpu")
    params = jp.model.init(jax.random.PRNGKey(0), jp.geom, jnp.asarray(jp.train_data["x"][:1]))["params"]
    tp.model.load_state_dict(flax_params_to_state_dict(params))
    rng = np.random.default_rng(0)
    perm = np.stack([rng.permutation(n_train)[:B] for _ in range(args.steps)])

    lr = t_configs.VORTICITY.lr
    optimizer = j_loop.make_optimizer(lr, args.steps)
    opt_state = optimizer.init(params)

    @jax.jit
    def step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(jp.task.loss_fn)(params, jp.geom, batch)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    t0 = time.perf_counter()
    jax_losses = []
    for idx in perm:
        params, opt_state, loss = step(params, opt_state, {k: v[idx] for k, v in jp.train_data.items()})
        jax_losses.append(float(loss))
    t1 = time.perf_counter()
    state = t_loop.TrainState(tp.model, t_loop.make_optimizer(tp.model.parameters(), lr))
    train_epoch = t_loop.make_train_epoch(tp.task, t_loop.make_lr_schedule(lr, args.steps))
    data = {k: torch.from_numpy(v) for k, v in tp.train_data.items()}
    state, losses = train_epoch(state, tp.geom, data, torch.from_numpy(perm))
    t2 = time.perf_counter()

    print(f"config: {vars(args)}; CPU seconds: JAX {t1 - t0:.1f}, port {t2 - t1:.1f}")
    rel = np.abs(losses.numpy() - np.array(jax_losses)) / np.abs(jax_losses)
    print(f"losses: max relative difference {rel.max():.3e}")
    want = flax_params_to_state_dict(params)
    worst_abs = worst_ratio = 0.0
    for k, v in tp.model.state_dict().items():
        w = want[k].numpy()
        diff = np.abs(v.numpy() - w)
        ratio = float((diff / (2e-5 + 5e-3 * np.abs(w))).max())
        worst_abs, worst_ratio = max(worst_abs, float(diff.max())), max(worst_ratio, ratio)
        print(f"  {k}: max abs {diff.max():.3e}, ratio to the one-step bound {ratio:.2f}")
    print(f"weights: max abs {worst_abs:.3e}, max ratio to the one-step bound {worst_ratio:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
