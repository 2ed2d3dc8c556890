"""Error handling of the port: the counterpart of ``volrt/utils/errors.py``
(the reference's CUDA shim: cuda_safe_call, cuda_safe_malloc and the
-nosafe flag, reference: cuda_utils.h:21-49, VolR.cpp:404-406).

Two pieces:

- :func:`safe_call`: run a step and log a failure; re-raise unless
  ``nosafe`` (the reference's continue-past-errors mode, ``--nosafe``).
- :func:`render_with_oom_fallback`: when a frame exhausts the card's
  memory (``torch.cuda.OutOfMemoryError``), render it again in row bands,
  each a shifted sub-view, on the same card with the same kernel, and
  stitch them; ray bundles are affine in the pixel index, so the bands'
  rays are the frame's. Any other error propagates.
"""
from __future__ import annotations

import dataclasses

import torch


def is_oom(exc: BaseException) -> bool:
    """True for the card's out-of-memory failure: torch's
    ``OutOfMemoryError``, or the ``RuntimeError`` whose message torch
    writes for it ("CUDA out of memory")."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    return isinstance(exc, RuntimeError) and "out of memory" in str(exc)


def safe_call(fn, *args, log=None, nosafe: bool = False, what: str = "",
              **kwargs):
    """Run ``fn`` and log a failure. Returns ``(result, error)``; with
    ``nosafe`` an error is swallowed (result None), else re-raised after
    logging, as cuda_safe_call logs and exits where -nosafe continues
    (reference: cuda_utils.h:25-39)."""
    try:
        return fn(*args, **kwargs), None
    except Exception as e:  # noqa: BLE001 — the shim's whole purpose
        if log is not None:
            log.log("ERROR in %s: %s", what or getattr(fn, "__name__", "?"),
                    e)
        if nosafe:
            return None, e
        raise


def band_view(view, r0: int, hb: int):
    """The sub-view that renders rows ``[r0, r0 + hb)`` of ``view``'s
    viewport.

    Ray bundles are affine in the pixel index (reference: ViewBase.h:23-35
    offsets by ``pos - dims/2``), so a band of rows is a smaller view whose
    centre moves by ``(r0 + hb//2 - h//2) * up_plane``: folded into the
    origin (orthographic) or the direction (perspective)."""
    w, h = view.dims
    shift = float(r0 + hb // 2 - h // 2)
    off = view.up_plane * shift
    if view.perspective:
        return dataclasses.replace(
            view, dims=(w, hb), direction=view.direction + off)
    return dataclasses.replace(view, dims=(w, hb), origin=view.origin + off)


def render_with_oom_fallback(render_fn, rc, log=None, max_splits: int = 4):
    """Render a frame, splitting the viewport into row bands when the card
    runs out of memory.

    ``render_fn(rc) -> (f32[H, W, 4], overflow)``; returns the stitched
    ``(f32[H, W, 4], total overflow)``, on the render's device. Each
    out-of-memory failure halves the band height (up to ``2**max_splits``
    bands); any other error propagates. The bands' rays are the frame's,
    so the stitched image is the frame's."""
    w, h = rc.view.dims
    n_bands = 1
    last: BaseException | None = None
    while n_bands <= (1 << max_splits):
        if h % n_bands:
            n_bands *= 2
            continue
        hb = h // n_bands
        try:
            rows, ovf = [], 0.0
            for b in range(n_bands):
                sub = rc.replace(view=band_view(rc.view, b * hb, hb))
                img, o = render_fn(sub)
                rows.append(img)
                ovf += float(o)
            out = rows[0] if n_bands == 1 else torch.cat(rows, dim=0)
            if n_bands > 1 and log is not None:
                log.log("rendered in %d row bands after running out of "
                        "memory", n_bands)
            return out, ovf
        except Exception as e:  # noqa: BLE001
            if not is_oom(e):
                raise
            last = e
            n_bands *= 2
    raise last  # type: ignore[misc]
