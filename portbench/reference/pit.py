"""Plain reference of the torch-family Position-induced Transformer (Chen &
Wu, ICML 2024, arXiv:2405.09285; the published ``pit.py`` of
junfeng-chen/position_induced_transformer), float32, on fixed meshes.

Encoder: the mesh coordinates are concatenated to the input function, a
cross position attention maps it from the input mesh onto the latent mesh,
then MLP and GELU. Processor: ``n_blocks`` times a global self position
attention whose output is concatenated to its input, then MLP and GELU.
Decoder: a cross position attention onto the output mesh, then an MLP; a
residual model adds its input. Position attention over squared distances
``d``: per head the weights ``softmax(-tan(pi/4 (1 - 1e-7) (1 + sin
lmda)) d)`` over the entries of each row at or below the row's
``locality`` quantile of ``d`` (every entry for a global op), applied to
the values, the heads concatenated per point. The loss is the relative L2
error summed over the batch (``swap_loss_args``: normalised by the
prediction, as the published cylinder script calls it).

Parameter names are the published state dict's. Everything is worked out
from the inputs: distances, quantiles and kept sets. Imports nothing of the
program under test.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.common import (
    Adam,
    Precision,
    cosine_lr,
    gelu,
    masked_softmax,
    quantile_keep,
    rel_l2_per_sample,
)

# the parameters that scale the distances in the position attention ops
BANDWIDTH_SUFFIX = ".lmda"
# the scale, over the median leaf's gradient, below which rounding swamps a
# bandwidth's gradient: a global op's sum over 896 x 896 entries leaves an
# error near 5e-8 of the median leaf's, so a bandwidth whose gradient is
# small is held against a thousandth of the median leaf's
BANDWIDTH_FLOOR = 1e-3
# whether :func:`loss` sums over the batch (else it takes the mean)
BATCH_SUMMED_LOSS = True
_BANDWIDTH_C = 0.25 * math.pi * (1.0 - 1e-7)


def param_shapes(cfg: dict) -> dict:
    """name -> shape of every parameter, in the published layout."""
    m = cfg["model"]
    H, hid = m["n_head"], m["hid_dim"]
    enc_in = H * (m["in_dim"] + (m["space_dim"] if m.get("concat_mesh", True) else 0))
    shapes = {"down.lmda": (H, 1, 1)}

    def mlp(prefix, i, h, o):
        shapes.update({f"{prefix}.mlp1.weight": (h, i), f"{prefix}.mlp1.bias": (h,),
                       f"{prefix}.mlp2.weight": (o, h), f"{prefix}.mlp2.bias": (o,)})

    mlp("en_layer", enc_in, hid, hid)
    for i in range(m["n_blocks"]):
        shapes[f"conv.{i}.lmda"] = (H, 1, 1)
        mlp(f"mlp.{i}", (1 + H) * hid, hid, hid)
    shapes["up.lmda"] = (H, 1, 1)
    mlp("de", H * hid, hid, m["out_dim"])
    return shapes


def init_rule(name: str, shapes: dict):
    """How the published model draws a parameter: kaiming-normal weights,
    ``nn.Linear``'s uniform bias, bandwidths uniform in [0, 1)."""
    if name.endswith(".lmda"):
        return ("uniform", 0.0, 1.0)
    if name.endswith(".weight"):
        return ("normal", math.sqrt(2.0 / shapes[name][1]))
    fan_in = shapes[name[: -len("bias")] + "weight"][1]
    bound = 1.0 / math.sqrt(fan_in)
    return ("uniform", -bound, bound)


def sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances (La, Lb), worked out in float64 and
    rounded once to float32."""
    a, b = a.double(), b.double()
    return ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1).float()


def geometry(cfg: dict, mesh: torch.Tensor, mesh_ltt: torch.Tensor) -> dict:
    """Distances and kept sets of the encoder (latent <- input mesh), the
    processor (latent <- latent) and the decoder (output mesh <- latent);
    the output mesh is the input mesh."""
    m = cfg["model"]
    g = {"mesh": mesh.float(), "dist_down": sq_dist(mesh_ltt, mesh),
         "dist_proc": sq_dist(mesh_ltt, mesh_ltt), "dist_up": sq_dist(mesh, mesh_ltt)}
    g["keep_down"] = quantile_keep(g["dist_down"], m["en_loc"]) if m["en_loc"] < 1 else None
    g["keep_up"] = quantile_keep(g["dist_up"], m["de_loc"]) if m["de_loc"] < 1 else None
    return g


def kept_counts(g: dict) -> dict:
    """Kept entries of each position attention op of one sample."""
    count = lambda keep, dist: dist.numel() if keep is None else int(keep.sum())
    return {"down": count(g["keep_down"], g["dist_down"]), "proc": g["dist_proc"].numel(),
            "up": count(g["keep_up"], g["dist_up"])}


def posatt(prec: Precision, dist, keep, lmda, u):
    """(B, L_out, H*D): every head's masked softmax of ``-scale d`` on the
    values ``u`` (B, L_in, D)."""
    scale = torch.tan(_BANDWIDTH_C * (1.0 + torch.sin(lmda)))  # (H, 1, 1)
    att = masked_softmax(-scale * dist[None], None if keep is None else keep[None])
    out = prec.einsum("hnj,bjd->bnhd", att, u)
    return out.reshape(out.shape[0], out.shape[1], -1)


def forward(cfg: dict, p: dict, g: dict, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    m = cfg["model"]
    mlp = lambda pre, t: prec.linear(
        gelu(prec.linear(t, p[f"{pre}.mlp1.weight"], p[f"{pre}.mlp1.bias"])),
        p[f"{pre}.mlp2.weight"], p[f"{pre}.mlp2.bias"])
    u = x
    if m.get("concat_mesh", True):
        u = torch.cat([g["mesh"].expand(x.shape[0], -1, -1), x], dim=-1)
    f = gelu(mlp("en_layer", posatt(prec, g["dist_down"], g["keep_down"], p["down.lmda"], u)))
    for i in range(m["n_blocks"]):
        f = torch.cat([f, posatt(prec, g["dist_proc"], None, p[f"conv.{i}.lmda"], f)], dim=-1)
        f = gelu(mlp(f"mlp.{i}", f))
    out = mlp("de", posatt(prec, g["dist_up"], g["keep_up"], p["up.lmda"], f))
    return out + x if m.get("residual_output", False) else out


def loss(cfg: dict, pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The batch-summed relative L2 loss of the configuration."""
    out_dim = cfg["model"]["out_dim"]
    if cfg.get("swap_loss_args", False):
        return rel_l2_per_sample(pred, y, out_dim).sum()
    return rel_l2_per_sample(y, pred, out_dim).sum()


def context(cfg: dict, inputs: dict) -> dict:
    """The geometry of the meshes in ``inputs`` (``mesh``, ``ltt``)."""
    return geometry(cfg, inputs["mesh"], inputs["ltt"])


def predict(cfg: dict, params: dict, g: dict, x: torch.Tensor, prec: Precision):
    return forward(cfg, params, g, x, prec)


def train(cfg: dict, params: dict, g: dict, batches, total_steps: int, prec: Precision,
          loss_fn=None, grad_fn=None):
    """Adam steps on ``batches`` (a list of (x, y)) from ``params``: each
    step's loss, the first step's gradients, and the parameters after the
    last step. ``loss_fn`` (a planted fault) replaces :func:`loss`;
    ``grad_fn`` (a planted fault) maps each step's gradients before the
    optimizer takes them."""
    loss_fn = loss_fn or loss
    params = {k: v.detach().clone() for k, v in params.items()}
    opt = Adam(params, "adam")
    losses, first_grads = [], None
    for step, (x, y) in enumerate(batches):
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        value = loss_fn(cfg, forward(cfg, leaves, g, x, prec), y)
        grads = dict(zip(leaves, torch.autograd.grad(value, list(leaves.values()))))
        grads = grads if grad_fn is None else grad_fn(grads)
        losses.append(float(value.detach()))
        first_grads = grads if first_grads is None else first_grads
        params = opt.step({k: v.detach() for k, v in leaves.items()}, grads,
                          cosine_lr(cfg["lr"], total_steps, step))
    return losses, first_grads, params
