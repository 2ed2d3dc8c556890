"""Checkpoint and resume of fitting runs: the counterpart of
``volrt/train/checkpoint.py``'s ``.npz`` format, so that either package
resumes from the other's file.

The file holds the scene's leaves, the step counter, ``meta`` (JSON bytes:
``ray_step`` and ``n_opt_leaves``) and the optimizer state as ``opt_0``
... ``opt_4`` in ``optax.adam``'s leaf order: ``count`` (int32), then
``mu`` and ``nu`` of ``(density, tf_base)``. Torch's Adam keeps a ``step``,
``exp_avg`` and ``exp_avg_sq`` per parameter: ``exp_avg`` is ``mu`` and
``exp_avg_sq`` is ``nu``, and both parameters' ``step`` is ``count``,
which ``volrt``'s single counter advances every step. A frozen leaf:
``volrt`` feeds its optimizer a zero gradient, so its moments stay zero
while ``count`` advances; the port turns its ``requires_grad`` off, so
torch's Adam keeps no state for it, and its moments are written as zeros
and read back as zeros at ``count``.

``volrt``'s other format, an orbax directory, is JAX's; a path that does
not end in ``.npz`` is refused.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from volrt_torch.diff.render import DiffScene
from volrt_torch.train.fit import TrainState, make_optimizer

# optax.adam's state leaves (jax.tree_util.tree_leaves of its init): the
# count, then each moment over the parameters (density, tf_base).
ADAM_LEAVES = ("count", ("exp_avg", 0), ("exp_avg", 1), ("exp_avg_sq", 0),
               ("exp_avg_sq", 1))


def check_path(path: str) -> None:
    """Refuse a checkpoint path that is not a ``.npz`` file."""
    if not str(path).endswith(".npz"):
        raise ValueError(
            f"checkpoint {path!r}: the port reads and writes .npz files "
            f"only (volrt's orbax directories are JAX's); give a path "
            f"ending in .npz")


def _params(scene: DiffScene) -> tuple[torch.Tensor, torch.Tensor]:
    return scene.density, scene.tf_base


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save(path: str, state: TrainState, gather=None,
         write: bool = True) -> None:
    """Write ``state`` to the ``.npz`` file ``path``, through a temporary
    file and ``os.replace``, as ``volrt`` writes it.

    Volume-sharded training (``fit(volume_sharded=True)``) holds one slab
    of the density a rank: ``gather`` maps a slab-shaped tensor (the
    density, its Adam moments) to the whole volume's host array, a
    collective that every rank calls, and only the rank with ``write``
    writes the file."""
    check_path(path)
    params = _params(state.scene)
    whole = gather or _host  # the density and its moments
    leaves = []
    for leaf in ADAM_LEAVES:
        if leaf == "count":
            leaves.append(np.asarray(state.step, np.int32))
            continue
        key, i = leaf
        p = params[i]
        moment = state.optimizer.state.get(p, {}).get(key)
        host = whole if i == 0 else _host
        leaves.append(host(torch.zeros_like(p) if moment is None
                           else moment))
    density = whole(state.scene.density)
    if not write:
        return
    arrays = {
        "density": density,
        "tf_base": state.scene.tf_base.detach().cpu().numpy(),
        "step": np.asarray(state.step, np.int32),
        "meta": np.frombuffer(json.dumps({
            "ray_step": state.scene.ray_step,
            "n_opt_leaves": len(leaves),
        }).encode(), dtype=np.uint8),
    }
    for i, leaf in enumerate(leaves):
        arrays[f"opt_{i}"] = leaf
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    os.replace(tmp + ".npz", path)


def restore(path: str, state: TrainState, rows: slice = slice(None)
            ) -> TrainState:
    """Read the ``.npz`` file ``path`` into ``state``: the leaves are
    copied into its scene in place (their shapes must match) and the
    scene takes the file's ``ray_step``; the optimizer's state and the step
    are the file's. ``rows`` cuts the density and its moments to a slab's
    rows (volume-sharded training). Returns ``state``."""
    check_path(path)
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta["n_opt_leaves"] != len(ADAM_LEAVES):
            raise ValueError(
                f"{path}: {meta['n_opt_leaves']} optimizer leaves, not "
                f"optax.adam's {len(ADAM_LEAVES)}")
        opt = [z[f"opt_{i}"] for i in range(len(ADAM_LEAVES))]
        opt[1], opt[3] = opt[1][rows], opt[3][rows]
        scene = state.scene
        params = _params(scene)
        with torch.no_grad():
            for p, name in zip(params, ("density", "tf_base")):
                arr = z[name][rows] if name == "density" else z[name]
                if tuple(arr.shape) != tuple(p.shape):
                    raise ValueError(f"{path}: {name} is {arr.shape}, the "
                                     f"scene's {tuple(p.shape)}")
                p.copy_(torch.from_numpy(arr))
        scene.ray_step = float(meta["ray_step"])
        count = int(opt[0])
        for i, p in enumerate(params):
            state.optimizer.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": torch.from_numpy(opt[1 + i]).to(p.device),
                "exp_avg_sq": torch.from_numpy(opt[3 + i]).to(p.device),
            }
        state.step = int(z["step"])
    return state


def load(path: str, lr: float = 1e-2,
         device: torch.device | str | None = None) -> TrainState:
    """A new train state from the ``.npz`` file ``path`` on ``device``
    (the card when ``None``): its scene, Adam at ``lr`` (``optax.adam``'s
    defaults otherwise) with the file's state, and its step."""
    check_path(path)
    from volrt_torch.core.device import resolve_device

    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        dev = resolve_device(device)
        scene = DiffScene(torch.from_numpy(z["density"]).to(dev),
                          torch.from_numpy(z["tf_base"]).to(dev),
                          meta["ray_step"])
    return restore(path, TrainState(scene, make_optimizer(scene, lr), 0))
