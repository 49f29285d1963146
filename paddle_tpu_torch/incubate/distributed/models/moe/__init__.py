"""Mixture-of-Experts for the PyTorch port: the gating functions, the
dispatch and combine functions, the gates and ``MoELayer``.

Counterpart of ``paddle_tpu/incubate/distributed/models/moe/__init__.py``
on one device: ``top1_gating`` :32, ``top2_gating`` :59, ``_topk_picks``
:98, ``topk_gating`` :118, ``topk_gating_idx`` :146, ``indexed_dispatch``
:183, ``inverted_dispatch`` :203, ``indexed_combine`` :222,
``expert_choice_gating`` :232, the gates :255-283 and ``MoELayer`` :286.
The arithmetic is the reference's: f32 router probabilities, the argmax
taken k times with the chosen experts masked out (``torch.argmax``
returns the first maximum, as ``jnp.argmax`` does), queue positions from
an f32 ``cumsum`` of one-hots, later choices queued after the earlier
choices' counts, a fixed capacity past which a (token, choice) pair is
dropped.

The reference's expert parallelism is the ``P("expert", None, "model")`` /
``P("expert", "model", None)`` annotation of ``w_in`` / ``w_out`` under a
mesh (``:326-327``); here ``MoELayer.distribute(mesh)`` (one rank of the
mesh per process) keeps this rank's experts and its "model" share of
their hidden columns, and the layer then runs:

* over "expert" and "model", where the batch is replicated as the
  reference lays it out: every rank routes all of its tokens, dispatches
  only to its own experts, computes their FFN on its hidden columns (the
  GELU is elementwise, so the column split is exact) and the partial
  combine is summed over both axes (``mp_allreduce``). The combine
  weights and the dispatched tokens enter through ``c_identity``, whose
  backward sums their gradients over both axes, so that the router's and
  the input's gradients are whole on every rank (the load-balancing
  loss, computed alike on every rank, is not summed again);
* over "data", the reference's GLOBAL routing (its T = B·S is the
  global batch, ``:335-340``): the capacity from the global token count;
  each (token, choice)'s queue position its local one plus the earlier
  choices' global counts and this choice's counts on the earlier data
  ranks (one all-gather of each rank's (k, E) counts: an exclusive scan);
  the load-balancing loss from the global means (the probabilities'
  through ``all_reduce_with_grad``); the top-1 noise this rank's rows of
  one global (T, E) draw (``_DataRoute``). Expert-choice routing under
  "data" would need a global top-C over the tokens, and is refused.

No TPU kernel lies in this module: gating, dispatch, combine and the
expert products are plain ``jnp`` in the reference and plain PyTorch
here (``torch.bmm``, ``index_add``, gathers).

Two things a port could get wrong:

* A dropped pair keeps position 0, so its slot ``e·C + 0`` may belong to
  a kept token. The reference ADDS the dropped pair's zero update there
  (``.at[].add``); ``indexed_dispatch`` adds too (``index_add``), where a
  copy or a plain index assignment would overwrite the kept token.
* The experts' GELU is ``jax.nn.gelu``'s default, the tanh form.

Top-1 noise (``eps_std`` 0.01 in training) is drawn from a
``torch.Generator``: afresh on every call, where the reference's
compiled step bakes the key it drew while tracing into the program
(ROADMAP Queue 3).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..... import nn as pnn
from .....core.generator import torch_generator
from .....core.place import resolve_device


def _one_hot(idx, n):
    """f32 one-hot of ``idx`` over ``n`` classes; an index outside [0, n)
    gives a zero row, as ``jax.nn.one_hot`` does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(
        torch.float32)


def _positions(oh, prior):
    """Each token's place in its expert's queue: the running count of the
    one-hots ``oh`` (T, E) before it, after ``prior`` (1, E) earlier
    choices (f32 sums of 0/1, exact), as int32."""
    return torch.sum((torch.cumsum(oh, 0) - 1.0) * oh + prior * oh,
                     -1).to(torch.int32)


def _noised(logits, generator, eps_std, route=None):
    if generator is None or eps_std <= 0:
        return logits
    if route is not None:
        return logits + eps_std * route.noise(logits, generator)
    return logits + eps_std * torch.randn(logits.shape, generator=generator,
                                          device=logits.device,
                                          dtype=logits.dtype)


EXPERT_CHOICE_DATA = (
    "expert-choice routing over a 'data' axis above 1 needs a global "
    "top-C over the tokens of every data rank, which is not ported: "
    "ROADMAP Queue 1 item 15.12")


class _DataRoute:
    """The global routing of a batch split over a "data" group: this
    rank's tokens are the global token order's block ``rank`` (its rows of
    the batch), so each of its pairs queues after the pairs of the data
    ranks before it."""

    def __init__(self, group):
        self.group = group
        self.n, self.rank = group.nranks, group.rank

    def priors(self, ohs):
        """For each choice j of ``ohs`` ((T, E) f32 one-hots): the (1, E)
        count of pairs queued at each expert before this rank's choice-j
        pairs (every earlier choice's global count, then choice j's on
        the earlier ranks), and the (k, E) global counts. The counts are
        sums of 0/1 in f32, exact."""
        from .....distributed.collective import all_gather
        counts = torch.stack([torch.sum(oh, 0) for oh in ohs])
        every = torch.stack(all_gather([], counts, self.group))
        total = torch.sum(every, 0)
        before = torch.sum(every[:self.rank], 0)
        earlier = torch.cumsum(total, 0) - total
        return [(earlier[j] + before[j])[None] for j in range(len(ohs))], \
            total

    def aux(self, probs, total0):
        """E · Σ (the global share of tokens whose first choice is each
        expert) · (the global mean probability of it): Switch's eq. 4 over
        the global batch, differentiable through the probabilities."""
        T, E = probs.shape
        n_tokens = T * self.n
        from .....distributed.collective import all_reduce_with_grad
        mean_p = all_reduce_with_grad(torch.sum(probs, 0),
                                      self.group) / n_tokens
        return E * torch.sum(total0 / n_tokens * mean_p)

    def noise(self, logits, generator):
        """This rank's rows of one N(0, 1) draw of the global (T, E)."""
        T, E = logits.shape
        full = torch.randn((T * self.n, E), generator=generator,
                           device=logits.device, dtype=logits.dtype)
        return full[self.rank * T:(self.rank + 1) * T]


def top1_gating(logits, capacity, generator=None, eps_std=0.0, route=None):
    """Switch-style top-1 gate with the load-balancing aux loss; with a
    ``generator`` and ``eps_std`` > 0 the logits take N(0, eps_std²)
    noise first. ``route``: a ``_DataRoute`` (the global routing of a
    batch split over "data"; ``capacity`` then the global one), else the
    batch is the whole.

    Returns (dispatch (T, E, C) f32 0/1, combine (T, E, C) f32, aux)."""
    T, E = logits.shape
    probs = torch.softmax(_noised(logits, generator, eps_std, route), -1)
    onehot = _one_hot(torch.argmax(probs, -1), E)
    if route is None:
        # Switch eq. 4: E * sum(fraction of tokens * fraction of probability)
        aux = E * torch.sum(torch.mean(onehot, 0) * torch.mean(probs, 0))
        pos = _positions(onehot, 0.0)
    else:
        priors, total = route.priors([onehot])
        aux = route.aux(probs, total[0])
        pos = _positions(onehot, priors[0])
    keep = pos < capacity
    gate_val = torch.sum(probs * onehot, -1) * keep
    dispatch = onehot[:, :, None] * _one_hot(pos, capacity)[:, None, :]
    dispatch = dispatch * keep[:, None, None]
    return dispatch, dispatch * gate_val[:, None, None], aux


def top2_gating(logits, capacity, route=None):
    """GShard top-2 gate: the two probabilities renormalised, second
    choices queued after every first choice (the reference's unused
    ``noise_key`` is not taken); ``route`` as ``top1_gating``'s."""
    T, E = logits.shape
    probs = torch.softmax(logits, -1)
    g1, p1 = torch.argmax(probs, -1), torch.amax(probs, -1)
    probs2 = probs * (1 - _one_hot(g1, E).to(probs.dtype))
    g2, p2 = torch.argmax(probs2, -1), torch.amax(probs2, -1)
    denom = torch.clamp_min(p1 + p2, 1e-9)
    p1, p2 = p1 / denom, p2 / denom
    oh1, oh2 = _one_hot(g1, E), _one_hot(g2, E)
    if route is None:
        aux = E * torch.sum(torch.mean(oh1, 0) * torch.mean(probs, 0))
        pos1 = _positions(oh1, 0.0)
        pos2 = _positions(oh2, torch.sum(oh1, 0, keepdim=True))
    else:
        priors, total = route.priors([oh1, oh2])
        aux = route.aux(probs, total[0])
        pos1, pos2 = _positions(oh1, priors[0]), _positions(oh2, priors[1])
    keep1, keep2 = pos1 < capacity, pos2 < capacity

    def disp(oh, pos, keep, p):
        d = oh[:, :, None] * _one_hot(pos, capacity)[:, None, :]
        d = d * keep[:, None, None]
        return d, d * (p * keep)[:, None, None]

    d1, c1 = disp(oh1, pos1, keep1, p1)
    d2, c2 = disp(oh2, pos2, keep2, p2)
    return torch.maximum(d1, d2), c1 + c2, aux


def _picks(probs, k):
    """The argmax k times with the chosen experts masked out: [(expert
    ids, probs, f32 one-hot)] * k."""
    E = probs.shape[1]
    remaining, picks = probs, []
    for _ in range(k):
        g, p = torch.argmax(remaining, -1), torch.amax(remaining, -1)
        oh = _one_hot(g, E)
        remaining = remaining * (1 - oh)
        picks.append((g, p, oh))
    return picks


def _topk_picks(probs, k):
    """The pick loop shared by the dense and the index-form gates
    (``_picks``). Returns ([(expert ids, probs, f32 one-hot)] * k, aux)."""
    E = probs.shape[1]
    picks = _picks(probs, k)
    aux = E * torch.sum(torch.mean(picks[0][2], 0) * torch.mean(probs, 0))
    return picks, aux


def _routed_picks(probs, k, route):
    """``_topk_picks`` and the queue priors of the choices: None without
    ``route`` (each choice queues after the earlier choices' counts),
    else the global batch's (``_DataRoute.priors``), the aux loss then
    the global one."""
    if route is None:
        return (*_topk_picks(probs, k), None)
    picks = _picks(probs, k)
    priors, total = route.priors([oh for _, _, oh in picks])
    return picks, route.aux(probs, total[0]), priors


def topk_gating(logits, capacity, k, route=None):
    """Dense top-k gate (the fine-grained DeepSeek / Qwen regimes): the k
    probabilities renormalised, each choice queued after every earlier
    choice's per-expert count. For k = 2 this is ``top2_gating``;
    ``route`` as ``top1_gating``'s."""
    T, E = logits.shape
    probs = torch.softmax(logits, -1)
    picks, aux, priors = _routed_picks(probs, k, route)
    denom = torch.clamp_min(sum(p for _, p, _ in picks), 1e-9)
    dispatch = torch.zeros((T, E, capacity), dtype=torch.float32,
                           device=logits.device)
    combine = torch.zeros_like(dispatch)
    prior = torch.zeros((1, E), dtype=torch.float32, device=logits.device)
    for j, (_, p, oh) in enumerate(picks):
        pos = _positions(oh, prior if priors is None else priors[j])
        keep = pos < capacity
        d = oh[:, :, None] * _one_hot(pos, capacity)[:, None, :]
        d = d * keep[:, None, None]
        dispatch = torch.maximum(dispatch, d)
        combine = combine + d * ((p / denom) * keep)[:, None, None]
        prior = prior + torch.sum(oh, 0, keepdim=True)
    return dispatch, combine, aux


def topk_gating_idx(logits, capacity, k, generator=None, eps_std=0.0,
                    route=None):
    """Index-form gate: the expert choices, queue positions and combine
    weights of the dense gates, per (token, choice). k = 1 keeps the raw
    top-1 probability (Switch), k > 1 renormalises the k of them; the
    noise and ``route`` are ``top1_gating``'s.

    Returns (eids (T, k) int32, pos (T, k) int32 — 0 where dropped, keep
    (T, k) bool, w (T, k) f32 — 0 where dropped, aux)."""
    T, E = logits.shape
    probs = torch.softmax(_noised(logits, generator, eps_std, route), -1)
    picks, aux, priors = _routed_picks(probs, k, route)
    if k == 1:
        weights = [picks[0][1]]
    else:
        denom = torch.clamp_min(sum(p for _, p, _ in picks), 1e-9)
        weights = [p / denom for _, p, _ in picks]
    eids, poss, keeps, ws = [], [], [], []
    prior = torch.zeros((1, E), dtype=torch.float32, device=logits.device)
    for j, ((g, _, oh), w) in enumerate(zip(picks, weights)):
        pos = _positions(oh, prior if priors is None else priors[j])
        keep = pos < capacity
        eids.append(g.to(torch.int32))
        poss.append(torch.where(keep, pos, 0))
        keeps.append(keep)
        ws.append(w * keep)
        prior = prior + torch.sum(oh, 0, keepdim=True)
    return (torch.stack(eids, 1), torch.stack(poss, 1),
            torch.stack(keeps, 1), torch.stack(ws, 1), aux)


def indexed_dispatch(xt, eids, pos, keep, capacity, num_experts):
    """(T, H) tokens -> (E, C, H) expert inputs by a scatter-add. Kept
    pairs hold distinct slots; a dropped pair adds a zero row to slot
    ``e·C + 0``, which a kept token may hold (so an add, never a copy)."""
    T, H = xt.shape
    k = eids.shape[1]
    flat = (eids.long() * capacity + pos.long()).reshape(T * k)
    upd = xt[:, None, :].expand(T, k, H).reshape(T * k, H)
    upd = upd * keep.reshape(T * k, 1).to(xt.dtype)
    buf = xt.new_zeros((num_experts * capacity, H)).index_add(0, flat, upd)
    return buf.reshape(num_experts, capacity, H)


def inverted_dispatch(xt, eids, pos, keep, capacity, num_experts):
    """The expert inputs of ``indexed_dispatch`` by slot inversion and a
    row gather: the one scatter is of (T·k,) token ids into the slots
    (dropped pairs to the sentinel slot E·C); an empty slot holds the
    sentinel token T and gathers the zero row appended to ``xt``."""
    T, H = xt.shape
    k = eids.shape[1]
    EC = num_experts * capacity
    flat = torch.where(keep, eids.long() * capacity + pos.long(),
                       EC).reshape(T * k)
    tokens = torch.arange(T, device=xt.device).repeat_interleave(k)
    inv = torch.full((EC + 1,), T, dtype=torch.long,
                     device=xt.device).scatter_(0, flat, tokens)
    padded = torch.cat([xt, xt.new_zeros((1, H))])
    return padded[inv[:EC]].reshape(num_experts, capacity, H)


def indexed_combine(expert_out, eids, pos, w, capacity):
    """(E, C, H) expert outputs -> (T, H) tokens: each (token, choice)
    slot gathered and weighted by ``w`` (0 for a dropped pair), summed
    over the k choices."""
    E, C, H = expert_out.shape
    flat = eids.long() * capacity + pos.long()
    g = expert_out.reshape(E * C, H)[flat]
    return torch.sum(g * w[..., None].to(expert_out.dtype), -2)


def expert_choice_gating(logits, capacity):
    """Expert-choice routing (Zhou et al. 2022): each expert takes its
    top-``capacity`` tokens by router probability (at most T), so there
    is no aux loss and nothing is dropped; a token may be taken by 0..E
    experts.

    Returns (dispatch (T, E, C), combine (T, E, C), aux = 0)."""
    T, E = logits.shape
    capacity = min(capacity, T)
    probs = torch.softmax(logits, -1)
    g, idx = torch.topk(probs.T, capacity)          # (E, C), descending
    dispatch = _one_hot(idx, T).permute(2, 0, 1)
    return (dispatch, dispatch * g[None, :, :],
            torch.zeros((), dtype=torch.float32, device=logits.device))


class BaseGate(pnn.Layer):
    """The router: ``wg`` (d_model, num_experts), no bias."""

    routing = "token"   # tokens pick experts (the GShard / Switch family)

    def __init__(self, d_model, num_experts, *, device=None, generator=None):
        super().__init__()
        self.wg = pnn.Linear(d_model, num_experts, bias_attr=False,
                             device=device, generator=generator)
        self.num_experts = num_experts


class SwitchGate(BaseGate):
    top_k = 1


class GShardGate(BaseGate):
    top_k = 2


class NaiveGate(BaseGate):
    top_k = 2


class ExpertChoiceGate(BaseGate):
    """Experts pick tokens; ``top_k`` only feeds the capacity formula."""

    routing = "expert"
    top_k = 2


GATES = {"gshard": GShardGate, "switch": SwitchGate, "naive": NaiveGate,
         "expert_choice": ExpertChoiceGate}
DISPATCH_MODES = ("indexed", "inverted", "einsum")


def _fan_in_out(shape):
    """The reference's fan rule (``nn/initializer/__init__.py:18-30``):
    a 3-D (E, a, b) weight has fan_in a·b and fan_out E·b."""
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def xavier_normal_std(shape):
    """The std of the reference's ``XavierNormal`` for ``shape``."""
    fan_in, fan_out = _fan_in_out(tuple(shape))
    return math.sqrt(2.0 / (fan_in + fan_out))


class MoELayer(pnn.Layer):
    """Routed experts: the gate ``gate.wg`` (d_model, E) and stacked
    expert weights ``w_in`` (E, d_model, d_hidden), ``w_out`` (E,
    d_hidden, d_model), each expert a two-matrix FFN with the tanh GELU.
    ``forward`` sets ``aux_loss`` (the gate's load-balancing loss in the
    activations' dtype) and, in the index-form dispatch modes,
    ``routing``: the last call's capacity and its (T, k) expert ids,
    queue positions and keep flags (over the global batch's queues on a
    mesh with "data").

    ``gate``: "gshard", "switch", "naive", "expert_choice" or a gate
    module; ``top_k`` overrides the gate's own. ``dispatch_mode``:
    "indexed" (scatter-add dispatch, gather combine), "inverted" (slot
    inversion and a row gather) or "einsum" (the dense one-hot (T, E, C)
    products, the reference's numerics oracle). Expert-choice routing
    takes a gather and a scatter-add under "indexed" (duplicate tokens:
    on the card their sum's order is not fixed) and the dense products
    otherwise, as in the reference. ``group`` and ``recompute_interval``
    are taken and not read, as in the reference; ``name`` is unused.

    Weights are drawn in f32 on ``device`` (``cuda`` unless ``"cpu"`` is
    asked for) from ``generator`` (the default generator when None):
    ``gate.wg`` XavierNormal, ``w_in`` / ``w_out`` XavierNormal by the
    reference's 3-D fan rule. The top-1 noise is drawn from ``generator``
    too.

    ``distribute(mesh)`` spreads the layer over a mesh (the module
    docstring): this rank then holds its experts' rows of ``w_in`` /
    ``w_out`` and its "model" share of their hidden columns."""

    def __init__(self, d_model, d_hidden, num_experts, gate="gshard",
                 capacity_factor=1.25, top_k=None, group=None,
                 recompute_interval=0, dispatch_mode="indexed", name=None,
                 *, device=None, generator=None):
        super().__init__()
        if dispatch_mode not in DISPATCH_MODES:
            raise ValueError(f"dispatch_mode must be one of "
                             f"{DISPATCH_MODES}; got {dispatch_mode!r}")
        dev = resolve_device(device)
        self.d_model, self.d_hidden = d_model, d_hidden
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.dispatch_mode = dispatch_mode
        self.generator = generator
        self.gate = GATES[gate](d_model, num_experts, device=dev,
                                generator=generator) \
            if isinstance(gate, str) else gate
        self.top_k = top_k or getattr(self.gate, "top_k", 2)
        draw = torch_generator(generator, dev)
        self.w_in = nn.Parameter(self._xavier(
            (num_experts, d_model, d_hidden), dev, draw))
        self.w_out = nn.Parameter(self._xavier(
            (num_experts, d_hidden, d_model), dev, draw))
        self.aux_loss = None
        self.routing = None
        self.mesh = None

    @staticmethod
    def _xavier(shape, dev, generator):
        return torch.empty(shape, device=dev).normal_(
            0.0, xavier_normal_std(shape), generator=generator)

    def distribute(self, mesh):
        """Spread the layer over ``mesh`` (a ``distributed.build_mesh``,
        this process one rank of it), IN PLACE: ``w_in`` and ``w_out``
        become this rank's shards under ``EXPERT_SPECS`` (new parameters,
        cut from the whole weights the layer holds: call it once), and
        ``forward`` runs over the mesh's "expert", "model" and "data" axes
        (the module docstring). Other axes replicate."""
        from .....distributed.topology import shard_of
        coords = {a: mesh.coordinate(a) for a in mesh.axis_names}
        with torch.no_grad():
            for name, spec in EXPERT_SPECS.items():
                full = getattr(self, name)
                setattr(self, name, nn.Parameter(
                    shard_of(full.detach(), spec, mesh.shape, coords)
                    .clone(), requires_grad=full.requires_grad))
        self.mesh = mesh

    def _spread(self):
        """(the ``_DataRoute`` over "data" or None, the groups of "expert"
        and "model" the partial outputs are summed over, this rank's first
        expert)."""
        mesh = self.mesh
        if mesh is None:
            return None, [], 0
        shape = mesh.shape
        route = _DataRoute(mesh.group("data")) \
            if shape.get("data", 1) > 1 else None
        parts = [mesh.group(a) for a in ("expert", "model")
                 if shape.get(a, 1) > 1]
        first = mesh.coordinate("expert") * self.w_in.shape[0] \
            if shape.get("expert", 1) > 1 else 0
        return route, parts, first

    def capacity(self, num_tokens):
        cap = int(math.ceil(self.top_k * self.capacity_factor * num_tokens
                            / self.num_experts))
        return max(cap, 4)

    def expert_ffn(self, expert_in):
        """(E, C, d_model) -> (E, C, d_model): each expert's
        ``gelu_tanh(x @ w_in[e]) @ w_out[e]`` (this rank's experts and
        hidden columns on a mesh)."""
        h = F.gelu(torch.bmm(expert_in, self.w_in), approximate="tanh")
        return torch.bmm(h, self.w_out)

    def forward(self, x):
        B, S, H = x.shape
        T, E, k = B * S, self.num_experts, self.top_k
        route, parts, e0 = self._spread()
        cap = self.capacity(T if route is None else T * route.n)
        xt = x.reshape(T, H)
        glt = self.gate.wg(x).reshape(T, E).to(torch.float32)
        noise = torch_generator(self.generator, x.device) \
            if self.training and k == 1 else None
        eps_std = 0.01 if noise is not None else 0.0
        mode = self.dispatch_mode
        n_local = self.w_in.shape[0]
        if getattr(self.gate, "routing", "token") == "expert":
            if route is not None:
                raise NotImplementedError(EXPERT_CHOICE_DATA)
            if mode == "indexed":
                # experts pick tokens: the top-k's (E, c) token indices
                # gather the inputs; the weighted outputs scatter-add back
                c = min(cap, T)
                g, idx = torch.topk(torch.softmax(glt, -1).T, c)
                if parts:
                    g = _whole(g, parts)[e0:e0 + n_local]
                    idx = idx[e0:e0 + n_local]
                    xt = _whole(xt, parts)
                expert_out = self.expert_ffn(xt[idx])
                contrib = g[..., None].to(xt.dtype) * expert_out
                out = xt.new_zeros((T, H)).index_add(
                    0, idx.reshape(-1), contrib.reshape(-1, H))
                self.aux_loss = xt.new_zeros(())
                return _summed(out, parts).reshape(B, S, H)
            dispatch, combine, aux = expert_choice_gating(glt, cap)
        elif mode in ("indexed", "inverted"):
            eids, pos, keep, w, aux = topk_gating_idx(glt, cap, k, noise,
                                                      eps_std, route)
            self.routing = {"capacity": cap, "eids": eids.detach(),
                            "pos": pos.detach(), "keep": keep.detach()}
            disp = inverted_dispatch if mode == "inverted" \
                else indexed_dispatch
            if parts:
                # this rank's experts only: another's pairs are dropped
                # here, with weight 0
                mine = (eids >= e0) & (eids < e0 + n_local)
                eids = torch.where(mine, eids - e0, 0)
                keep = keep & mine
                pos = torch.where(keep, pos, 0)
                w = _whole(w, parts) * keep
                xt = _whole(xt, parts)
            expert_out = self.expert_ffn(disp(xt, eids, pos, keep, cap,
                                              n_local))
            self.aux_loss = aux.to(xt.dtype)
            return _summed(indexed_combine(expert_out, eids, pos, w, cap),
                           parts).reshape(B, S, H)
        elif k == 1:
            dispatch, combine, aux = top1_gating(glt, cap, noise, eps_std,
                                                 route)
        elif k == 2:
            dispatch, combine, aux = top2_gating(glt, cap, route)
        else:
            dispatch, combine, aux = topk_gating(glt, cap, k, route)
        if parts:
            dispatch = dispatch[:, e0:e0 + n_local]
            combine = _whole(combine, parts)[:, e0:e0 + n_local]
            xt = _whole(xt, parts)
        expert_in = torch.einsum("tec,th->ech", dispatch.to(xt.dtype), xt)
        out = torch.einsum("tec,ech->th", combine.to(xt.dtype),
                           self.expert_ffn(expert_in))
        self.aux_loss = aux.to(xt.dtype)
        return _summed(out, parts).reshape(B, S, H)


# the reference's annotations of the stacked expert weights (``:326-327``)
EXPERT_SPECS = {"w_in": ("expert", None, "model"),
                "w_out": ("expert", "model", None)}


def _whole(t, groups):
    """``t`` (the same on every rank of ``groups``) through ``c_identity``
    over each group: its gradient, each rank's part, summed."""
    from .....distributed.collective import c_identity
    for g in groups:
        t = c_identity(t, g)
    return t


def _summed(t, groups):
    """The ranks' partial ``t`` summed over each of ``groups``
    (``mp_allreduce``: the gradient passed through)."""
    from .....distributed.collective import mp_allreduce
    for g in groups:
        t = mp_allreduce(t, g)
    return t
