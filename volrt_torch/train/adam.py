"""The trainer's optimiser: Adam as ``optax.adam`` has it, with the [0, 1]
clamp of each leaf in the same pass, on the card one launch of
``csrc/adam.cu`` a trained leaf.

:func:`adam_step` updates one leaf and its two moments in place; on CPU
tensors it runs its plain version, :func:`adam_step_plain`, which is
``torch.optim.Adam``'s single-tensor step (betas (0.9, 0.999), eps 1e-8
added outside the square root, no weight decay) followed by ``clamp_``,
operation for operation, and so gives its bits. On CUDA tensors it
launches the kernel or raises. :class:`Adam` keeps the state that
``torch.optim.Adam`` keeps, under the same names, which
``train/checkpoint.py`` writes and restores; it is not a
``torch.optim.Optimizer``, whose first construction imports
``torch._dynamo`` (some 9 s of a trainer's set-up).
"""
from __future__ import annotations

import ctypes

import torch

from volrt_torch.renderers.cuda.march import (
    _F, _I, _P, _launch, check_tensors)

BETAS = (0.9, 0.999)
EPS = 1e-8
# p, g, m, v, n, w1, beta2, w2, neg_step, bc2_sqrt, eps, lo, hi, clamp,
# blocks, stream
_ADAM_ARGTYPES = ([_P] * 4 + [ctypes.c_longlong] + [_F] * 8 + [_I, _I]
                  + [_P])


def _scalars(lr: float, step: int) -> dict:
    """The step's scalars as ``torch.optim.Adam`` computes them, in double:
    its bias corrections at ``step`` (1, 2, ...)."""
    b1, b2 = BETAS
    return {"w1": 1 - b1, "beta2": b2, "w2": 1 - b2,
            "step_size": lr / (1 - b1 ** step),
            "bc2_sqrt": (1 - b2 ** step) ** 0.5, "eps": EPS}


def adam_step(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
              v: torch.Tensor, lr: float, step: int,
              clamp: tuple[float, float] | None = None) -> None:
    """Step ``step`` (1, 2, ...) of Adam at ``lr`` on the leaf ``p`` with
    gradient ``g``, its moments ``m`` (``exp_avg``) and ``v``
    (``exp_avg_sq``) updated in place, then ``p`` clamped to ``clamp``
    (``(lo, hi)``) if given. All four are f32 of one shape on one device,
    contiguous; on the card, 16-byte aligned too."""
    dev = p.device
    tensors = {"leaf": p, "grad": g, "exp_avg": m, "exp_avg_sq": v}
    check_tensors({name: (t, torch.float32, tuple(p.shape))
                   for name, t in tensors.items()}, dev)
    if dev.type == "cpu":
        adam_step_plain(p, g, m, v, lr, step, clamp)
        return
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    n = p.numel()
    if n == 0:
        return
    s = _scalars(lr, step)
    lo, hi = clamp if clamp is not None else (0.0, 0.0)
    # A thread for every four elements: on an H100 this read 90 % of the
    # bound at a 448 x 1792^2 slab, a grid of 2 to 16 blocks a
    # multiprocessor striding over the leaf 86 %.
    blocks = -(-n // (4 * 256))
    _launch("volrt_adam", _ADAM_ARGTYPES, dev, p.data_ptr(), g.data_ptr(),
            m.data_ptr(), v.data_ptr(), n, s["w1"], s["beta2"], s["w2"],
            -s["step_size"], s["bc2_sqrt"], s["eps"], lo, hi,
            int(clamp is not None), blocks)
    adam_step.launches += 1


adam_step.launches = 0


def adam_step_plain(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                    v: torch.Tensor, lr: float, step: int,
                    clamp: tuple[float, float] | None = None) -> None:
    """The plain torch version of :func:`adam_step`, same arguments:
    ``torch.optim.Adam``'s single-tensor step (``torch/optim/adam.py:
    _single_tensor_adam``) and ``clamp_``."""
    s = _scalars(lr, step)
    with torch.no_grad():
        m.lerp_(g, s["w1"])
        v.mul_(s["beta2"]).addcmul_(g, g, value=s["w2"])
        denom = (v.sqrt() / s["bc2_sqrt"]).add_(s["eps"])
        p.addcdiv_(m, denom, value=-s["step_size"])
        if clamp is not None:
            p.clamp_(*clamp)


class Adam:
    """Adam over ``params`` at ``lr``, with ``torch.optim.Adam``'s state:
    ``param_groups[0]`` holds ``lr``, ``betas`` and ``eps``; ``state[p]``,
    made at a leaf's first update, ``step`` (a CPU f32 tensor),
    ``exp_avg`` and ``exp_avg_sq``. A leaf whose ``grad`` is ``None``
    (frozen) is not updated and keeps no state."""

    def __init__(self, params, lr: float):
        self.params = list(params)
        self.param_groups = [{"params": self.params, "lr": lr,
                              "betas": BETAS, "eps": EPS}]
        self.state: dict[torch.Tensor, dict] = {}

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    def step(self, clamp: tuple[float, float] | None = None) -> None:
        """One update of every leaf that has a gradient, one
        :func:`adam_step` each; with ``clamp`` (``(lo, hi)``) every leaf is
        clamped too, an updated one in the same launch, a frozen one by
        ``clamp_``."""
        lr = self.param_groups[0]["lr"]
        for p in self.params:
            if p.grad is None:
                if clamp is not None:
                    with torch.no_grad():
                        p.clamp_(*clamp)
                continue
            st = self.state.get(p)
            if st is None:
                st = self.state[p] = {
                    "step": torch.tensor(0.0, dtype=torch.float32),
                    "exp_avg": torch.zeros_like(p),
                    "exp_avg_sq": torch.zeros_like(p)}
            st["step"] += 1
            adam_step(p, p.grad, st["exp_avg"], st["exp_avg_sq"], lr,
                      int(st["step"]), clamp)
