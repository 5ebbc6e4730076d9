"""AdamW with global-norm clipping and optional low-precision state.

The JAX package's optimizer on tensors, in its arithmetic and order: the
moments in float32 by default (``state_dtype="bfloat16"`` halves them),
bias correction and weight decay in float32, each result cast back to its
leaf's dtype.  Leaves go in JAX's flatten order (``utils/tree.py``).

``update`` is functional, as the JAX package's: it returns new parameters
and a new state and leaves its arguments as they were.  With
``inplace=True`` it writes the new values into the given parameter and
moment tensors instead (the same arithmetic, bit for bit) and returns
them: at qwen3-4b's full width on one card, new copies of the 8.8 GB of
bf16 parameters and 35 GB of float32 moments next to the old ones do not
fit.  Leaves are updated in chunks, so the float32 temporaries stay small
beside a 1.8 GB stacked FFN weight or an 8.6 GB embedding table.

Optimizer state follows parameter sharding (``state_logical_axes``: the
moments take their parameters' logical axes).  On
``torch.distributed.tensor.DTensor`` leaves each gradient is first laid
out as its parameter (the all-reduce or reduce-scatter of a sharded step),
the clipping norm is reduced over the mesh, and the chunks then run on
each device's local shards, which is the same elementwise update.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels import is_dtensor
from repro_torch.utils import tree

AdamWState = Dict  # {"m": tree, "v": tree, "step": int32 scalar}

_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: elements of a leaf updated at a time
CHUNK = 1 << 24


@dataclass(frozen=True)
class AdamW:
    learning_rate: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    state_dtype: str = "float32"

    def _lr(self, step: torch.Tensor):
        if callable(self.learning_rate):
            return self.learning_rate(step)
        return self.learning_rate

    def init(self, params) -> AdamWState:
        dt = _STATE_DTYPES[self.state_dtype]
        first = tree.leaves(params)
        device = first[0].device if first else None
        return {
            "m": tree.map_leaves(lambda p: torch.zeros_like(p, dtype=dt), params),
            "v": tree.map_leaves(lambda p: torch.zeros_like(p, dtype=dt), params),
            "step": torch.zeros((), dtype=torch.int32, device=device),
        }

    def state_logical_axes(self, param_logical) -> Dict:
        return {
            "m": param_logical,
            "v": param_logical,
            "step": (),
        }

    def update(self, params, grads, state: AdamWState, inplace: bool = False):
        """``(new params, new state)`` for ``grads`` (a tree of ``params``'
        structure).  Each leaf is updated CHUNK elements at a time (the
        update is elementwise, so this changes no bit), which bounds the
        float32 temporaries to a few chunks whatever the leaf's size."""
        new_step = state["step"] + 1
        flat_p = tree.leaves(params)
        flat_g = tree.leaves(grads)
        if any(is_dtensor(p) for p in flat_p):
            flat_g = [g.redistribute(p.device_mesh, p.placements)
                      if is_dtensor(g) and g.placements != p.placements else g
                      for p, g in zip(flat_p, flat_g)]
        scale = None
        if self.clip_norm is not None:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in flat_g))
            scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
            scale = _local(scale, replicate=True)

        step = _local(new_step, replicate=True)
        lr = self._lr(step)
        f32 = torch.tensor(0.0, dtype=torch.float32, device=step.device)
        bc1 = 1.0 - (f32 + self.b1) ** step.to(torch.float32)
        bc2 = 1.0 - (f32 + self.b2) ** step.to(torch.float32)

        def upd(p, g, m, v):
            if scale is not None:
                g = g * scale.to(g.dtype)
            g32 = g.float()
            m32 = m.float() * self.b1 + g32 * (1 - self.b1)
            v32 = v.float() * self.b2 + g32 * g32 * (1 - self.b2)
            mhat = m32 / bc1
            vhat = v32 / bc2
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            if self.weight_decay:
                delta = delta + self.weight_decay * p.float()
            return p.float() - lr * delta, m32, v32

        flat_m, flat_v = tree.leaves(state["m"]), tree.leaves(state["v"])
        out = []
        with torch.no_grad():
            for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
                new = (p, m, v) if inplace else tuple(torch.empty_like(t) for t in (p, m, v))
                # a gradient may be a strided view (an einsum's); it is only read
                views = [_local(p).view(-1), _local(g).reshape(-1),
                         _local(m).view(-1), _local(v).view(-1)]
                dst = [_local(t).view(-1) for t in new]
                for lo in range(0, p.numel(), CHUNK):
                    part = upd(*(t[lo:lo + CHUNK] for t in views))
                    for d, x in zip(dst, part):
                        d[lo:lo + CHUNK].copy_(x)     # cast back to the leaf's dtype
                out.append(new)
        new_p = tree.unflatten(params, [o[0] for o in out])
        new_m = tree.unflatten(state["m"], [o[1] for o in out])
        new_v = tree.unflatten(state["v"], [o[2] for o in out])
        return new_p, {"m": new_m, "v": new_v, "step": new_step}


def _local(t, replicate: bool = False):
    """A DTensor's local shard (made whole first with ``replicate``), or
    the tensor itself."""
    if not is_dtensor(t):
        return t
    return t.full_tensor() if replicate else t.to_local()
