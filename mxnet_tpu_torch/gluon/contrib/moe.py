"""Sparsely-gated mixture of experts — the port of
``mxnet_tpu/gluon/contrib/moe.py`` (``SparseMoE``).

The GShard/Switch dense-dispatch recipe, in static shapes:

- router: a softmax over the experts per token, its top k choices (k = 1
  Switch, k = 2 GShard);
- capacity: each expert takes at most C = ceil(k N / E x
  capacity_factor) tokens a batch, choice 0 first, then choice 1 after
  every choice-0 claim; a token over capacity is dropped by that expert
  (it contributes nothing through it);
- dispatch and combine are (N, E, C) one-hot masks, and the layer is three
  einsums (tokens to expert slots, the expert FFN, slots back to tokens);
- gates come from the router probabilities through the one-hot masks, so
  the router weight learns (``topk`` has no gradient): Switch scales by the
  raw probability, GShard normalizes over the chosen experts;
- the Switch load-balance loss E sum_e f_e p_e comes back beside the
  output.

The stacked expert Parameters carry ``sharding = (expert_axis, None,
...)``, a hint for expert parallelism that nothing reads until the port's
multi-GPU parallelism lands.
"""

from __future__ import annotations

import math

from ...base import MXNetError
from ..block import HybridBlock

__all__ = ["SparseMoE"]


class SparseMoE(HybridBlock):
    """A mixture-of-experts FFN: ``forward(x)`` with x (B, L, units) or
    (N, units) returns ``(y, aux_loss)``, y of x's shape and aux_loss a
    scalar.  ``activation`` is ``gelu``, ``relu`` or ``silu``."""

    def __init__(self, units, hidden_size, num_experts,
                 num_experts_per_token=2, capacity_factor=1.25,
                 activation="gelu", expert_axis="ep", **kwargs):
        super().__init__(**kwargs)
        if num_experts_per_token > num_experts:
            raise MXNetError("num_experts_per_token > num_experts")
        self._units = units
        self._hidden = hidden_size
        self._E = int(num_experts)
        self._k = int(num_experts_per_token)
        self._cf = float(capacity_factor)
        self._act = activation
        with self.name_scope():
            self.gate_weight = self.params.get(
                "gate_weight", shape=(units, num_experts), init=None)
            self.expert_w1 = self.params.get(
                "expert_w1", shape=(num_experts, units, hidden_size),
                init=None)
            self.expert_b1 = self.params.get(
                "expert_b1", shape=(num_experts, hidden_size), init="zeros")
            self.expert_w2 = self.params.get(
                "expert_w2", shape=(num_experts, hidden_size, units),
                init=None)
            self.expert_b2 = self.params.get(
                "expert_b2", shape=(num_experts, units), init="zeros")
        for p in (self.expert_w1, self.expert_b1, self.expert_w2,
                  self.expert_b2):
            p.sharding = (expert_axis,) + (None,) * (len(p.shape) - 1)

    def capacity(self, num_tokens):
        """Slots per expert for a batch of ``num_tokens`` tokens."""
        return max(1, int(math.ceil(self._k * num_tokens / self._E
                                    * self._cf)))

    def _activate(self, F, h):
        if self._act == "relu":
            return F.relu(h)
        if self._act == "silu":
            return F.silu(h)
        return F.gelu(h)

    def hybrid_forward(self, F, x, gate_weight, expert_w1, expert_b1,
                       expert_w2, expert_b2):
        E, k = self._E, self._k
        in_shape = x.shape
        xf = F.reshape(x, shape=(-1, self._units))             # (N, d)
        C = self.capacity(xf.shape[0])
        probs = F.softmax(F.dot(xf, gate_weight), axis=-1)      # (N, E)
        _, topi = F.topk(probs, k=k, ret_typ="both", axis=-1)   # (N, k)
        disps, raw_gates = [], []
        count = f_frac = None
        for j in range(k):
            oh = F.one_hot(F.reshape(F.slice_axis(topi, axis=1, begin=j,
                                                  end=j + 1), shape=(-1,)),
                           depth=E)                             # (N, E)
            pos = F.cumsum(oh, axis=0) - oh     # 0-based slot among choice j
            if count is None:
                f_frac = F.mean(oh, axis=0)     # top-1 load fraction (E,)
                count = F.sum(oh, axis=0, keepdims=True)
            else:
                pos = pos + count               # after the earlier choices
                count = count + F.sum(oh, axis=0, keepdims=True)
            slot = F.sum(pos * oh, axis=-1)                     # (N,)
            keep = F.clip(C - slot, a_min=0, a_max=1)           # slot < C
            slot_oh = F.one_hot(F.cast(F.clip(slot, a_min=0, a_max=C - 1),
                                       dtype="int32"), depth=C)  # (N, C)
            disps.append(F.expand_dims(oh * F.expand_dims(keep, axis=1),
                                       axis=2)
                         * F.expand_dims(slot_oh, axis=1))      # (N, E, C)
            raw_gates.append(F.sum(probs * oh, axis=-1))        # (N,)
        if k == 1:
            gates = raw_gates
        else:
            denom = raw_gates[0]
            for g in raw_gates[1:]:
                denom = denom + g
            gates = [g / denom for g in raw_gates]
        combine = None
        for disp_j, gate_j in zip(disps, gates):
            c = disp_j * F.reshape(gate_j, shape=(-1, 1, 1))
            combine = c if combine is None else combine + c
        dispatch = F.cast(combine > 0, dtype=x.dtype)            # (N, E, C)
        expert_in = F.einsum(dispatch, xf, subscripts="nec,nd->ecd")
        h = self._activate(
            F, F.einsum(expert_in, expert_w1, subscripts="ecd,edh->ech")
            + F.expand_dims(expert_b1, axis=1))
        out = F.einsum(h, expert_w2, subscripts="ech,ehd->ecd") \
            + F.expand_dims(expert_b2, axis=1)
        y = F.einsum(F.cast(combine, dtype=x.dtype), out,
                     subscripts="nec,ecd->nd")
        aux = F.sum(f_frac * F.mean(probs, axis=0)) * E
        return F.reshape(y, shape=in_shape), aux
