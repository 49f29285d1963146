"""The AdamW update and optimizer state of the port's train-step
factories.

Counterpart of ``paddle_tpu/models/nlp/train_utils.py:27-85``
(``zero_like_sharded``, ``adamw_update``, ``make_adamw_state``), with the
reference's host-memory moments (``make_adamw_state(offload=True)`` and
the chunked update of ``llama.py:652-737``).

On a mesh with a "sharding" axis of several ranks the moments are ZeRO-1:
each rank keeps the moments of its parameter shard's slice on the
dimension the reference shards them over (``zero_like_sharded``: the
largest dimension of the full parameter that is not split over another
axis and that the axis divides); ``apply_adamw`` updates that slice of
the parameter and all-gathers it over "sharding". AdamW is elementwise,
so the sliced update gives the same bits as the whole-tensor update.

``MeshData`` is what the factories share on a mesh (one rank of it per
process), the Llama step's too: the axis check, this rank's rows of
"data", gradients averaged over "data" (and "sep") in buckets, in f32 for
16-bit ones, and losses taken as global ratios (each rank's
numerator and denominator summed over "data" before the division, never a
mean of the ranks' means). Over every other axis the batch is replicated,
as the reference's ``data_sh = P("data")`` lays it out.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch

# tensors whose moments cross to the card together in an offloaded
# update: the reference's ``chunk_n`` (llama.py:676)
OFFLOAD_CHUNK = 4

# the axes a factory's mesh may name; gradients are averaged over "data"
# in flat buckets of ``GRAD_BUCKET_BYTES``
MESH_AXES = ("data", "pipe", "sharding", "sep", "model")
GRAD_BUCKET_BYTES = 256 * 2 ** 20
PIPE_NOT_PORTED = ("a {axis!r} axis above 1 is not ported yet: ROADMAP "
                   "Queue 1 item 15 (the pipeline)")


def check_mesh_axes(shape, axes=MESH_AXES):
    """Refuse a mesh ({axis: size}) naming an axis not in ``axes``
    (ValueError) or a "pipe" axis above 1 (NotImplementedError)."""
    unknown = set(shape) - set(axes)
    if unknown:
        raise ValueError(f"mesh axes {sorted(unknown)} are not among "
                         f"{tuple(axes)}")
    if shape.get("pipe", 1) > 1:
        raise NotImplementedError(PIPE_NOT_PORTED.format(axis="pipe"))


class MeshData:
    """A factory's view of its mesh (a ``distributed.build_mesh``, this
    process one rank of it): the batch split over "data", replicated over
    every other axis. ``axes``: the axes the factory takes (others are
    refused, and so is "pipe" above 1)."""

    def __init__(self, mesh, axes=MESH_AXES):
        check_mesh_axes(mesh.shape, axes)
        self.mesh = mesh
        self.n = mesh.shape.get("data", 1)
        self.row = mesh.coordinate("data") if self.n > 1 else 0
        self.group = mesh.group("data") if self.n > 1 else None

    def rows(self, *tensors):
        """This rank's rows of each global batch tensor (dim 0 cut into
        "data" equal blocks)."""
        out = []
        for t in tensors:
            if t.shape[0] % self.n:
                raise ValueError(f"a batch of {t.shape[0]} rows does not "
                                 f"divide over data={self.n}")
            b = t.shape[0] // self.n
            out.append(t[self.row * b:(self.row + 1) * b])
        return out

    def average(self, grads, *groups):
        """Average ``grads`` (a list; None entries skipped) in place over
        "data" and then over each of ``groups`` (None entries skipped), in
        buckets of ``GRAD_BUCKET_BYTES``: the axes the parameters are
        replicated over. A 16-bit gradient is averaged in f32 and rounded
        back once: summed in its own dtype it would round at each of the
        ranks' additions, and where an element cancels over the batch (a
        bias's, a norm's) those roundings are relative to the ranks'
        parts, not to the sum, which AdamW then steps by its sign. The f32
        copies are made a slice of ``GRAD_BUCKET_BYTES`` at a time (one
        bucket may be a 525 M-element embedding's gradient)."""
        from ...distributed.collective import all_reduce
        from ...distributed.fleet.utils.internal_storage import \
            reduce_in_place
        groups = [g for g in (self.group,) + groups if g is not None]
        if not groups:
            return
        step = GRAD_BUCKET_BYTES // 4

        def reduce(flat):
            for s in range(0, flat.numel(), step):
                part = flat[s:s + step]
                wide = part.float()
                for group in groups:
                    all_reduce(wide, group=group)
                    wide.div_(max(group.nranks, 1))
                if wide is not part:
                    part.copy_(wide)
            return flat

        with torch.no_grad():
            reduce_in_place([g for g in grads if g is not None], reduce,
                            GRAD_BUCKET_BYTES)

    def ratios(self, terms):
        """The global loss Σ_i (Σ_ranks num_i) / max(Σ_ranks den_i, 1) of
        ``terms`` [(numerator: a scalar of this rank's rows that the
        gradient flows through, denominator: its count)], as (the loss to
        differentiate on this rank, the global value). The loss to
        differentiate is n · num_i / (the global denominator): once the
        gradients are averaged over the n ranks of "data", the gradient of
        the global ratio, whatever each rank's count."""
        from ...distributed.collective import all_reduce
        flat = torch.stack([torch.as_tensor(x, dtype=torch.float32,
                                            device=terms[0][0].device)
                            .detach().reshape(())
                            for pair in terms for x in pair])
        if self.group is not None:
            all_reduce(flat, group=self.group)
        dens = torch.clamp_min(flat[1::2], 1)
        value = torch.sum(flat[0::2] / dens)
        loss = sum(self.n * num.to(torch.float32) / den
                   for (num, _), den in zip(terms, dens))
        return loss, value

    def offset_dropout(self, model):
        """Give every ``nn.Dropout`` of ``model`` a generator of this "data"
        rank's own (rank 0 keeps the model's): its draws seeded with the
        generator's seed plus the rank's "data" coordinate times the
        golden-ratio constant, so no two data ranks draw the same mask and
        the ranks of one data coordinate draw alike."""
        if self.row == 0:
            return
        from ...core.generator import Generator, default_generator
        from ... import nn as pnn
        made = {}
        for m in model.modules():
            if isinstance(m, pnn.Dropout):
                g = m.generator if m.generator is not None \
                    else default_generator()
                if id(g) not in made:
                    made[id(g)] = Generator(
                        (g.initial_seed() + self.row * GOLDEN) % 2 ** 63)
                m.generator = made[id(g)]


# the seed offset of one data rank's dropout from the next (2^64 / phi)
GOLDEN = 0x9E3779B97F4A7C15


def adamw_update(p, g, m, v, t, lr, beta1, beta2, eps, weight_decay,
                 accum_dtype=torch.float32):
    """One decoupled-weight-decay Adam step on a single tensor; moments in
    ``accum_dtype``, ``t`` the step as an f32 tensor, the param returned
    in its own dtype. The reference's formula, operation for operation.
    Returns new tensors (the caller updates in place)."""
    g = g.to(accum_dtype)
    m2 = beta1 * m + (1 - beta1) * g
    v2 = beta2 * v + (1 - beta2) * torch.square(g)
    mhat = m2 / (1 - beta1 ** t)
    vhat = v2 / (1 - beta2 ** t)
    delta = mhat / (torch.sqrt(vhat) + eps) \
        + weight_decay * p.to(accum_dtype)
    return (p.to(accum_dtype) - lr * delta).to(p.dtype), m2, v2


# elements of one slice of a tensor's update. The update is elementwise,
# so slices give the same bits as the whole tensor, and its f32
# temporaries (about 8 of them) stay at 256 MB each however large the
# tensor: one routed-expert weight of Qwen2-57B-A14B holds 587 M elements.
# A tensor within one slice is updated whole: slicing views cost the host
# time, which a step of many small tensors (BERT's) pays
UPDATE_SLICE = 1 << 26


def _update_one(params, grads, i, k, m, v, t, hyper, accum_dtype):
    """``adamw_update`` of tensor ``k`` (``grads[i]``) against the moments
    ``m`` and ``v``, all IN PLACE, ``UPDATE_SLICE`` elements at a time
    past one slice; the gradient is dropped once used."""
    parts = [(params[k], grads[i], m, v)]
    if params[k].numel() > UPDATE_SLICE:
        flat = (params[k].view(-1), grads[i].reshape(-1), m.view(-1),
                v.view(-1))
        parts = [tuple(x[s:s + UPDATE_SLICE] for x in flat)
                 for s in range(0, params[k].numel(), UPDATE_SLICE)]
    grads[i] = None
    for p, g, m, v in parts:
        new_p, m2, v2 = adamw_update(p, g, m, v, t, *hyper, accum_dtype)
        p.copy_(new_p)
        m.copy_(m2)
        v.copy_(v2)


def moment_dim(mesh, spec, v):
    """The dimension of ``v`` (this rank's shard of a parameter annotated
    ``spec``) whose slices the "sharding" ranks keep, or None: the first,
    by decreasing size of the full parameter, that ``spec`` leaves
    unsplit and the axis divides (``train_utils.py:40-46``)."""
    n = mesh.shape.get("sharding", 1)
    if n <= 1:
        return None
    spec = list(spec) + [None] * (v.dim() - len(spec))
    full = [v.shape[i] * (mesh.shape[a] if a in mesh.shape else 1)
            for i, a in enumerate(spec)]
    for i in sorted(range(v.dim()), key=lambda i: -full[i]):
        if spec[i] is None and full[i] % n == 0:
            return i
    return None


def _slice(mesh, d, t):
    """This sharding rank's slice of ``t`` on dimension ``d``."""
    n = mesh.shape["sharding"]
    size = t.shape[d] // n
    return t.narrow(d, mesh.coordinate("sharding") * size, size)


def _moment_shape(mesh, spec, v):
    d = moment_dim(mesh, spec, v)
    return v.shape if d is None else _slice(mesh, d, v).shape


def zero_like_sharded(mesh, shardings, name, v, accum_dtype=torch.float32,
                      offload=False):
    """Zeros for the moment of parameter ``name`` (``v``: this rank's shard,
    ``shardings[name]`` its spec): the shard's shape, cut on
    ``moment_dim`` to this sharding rank's slice; in pinned host memory
    with ``offload`` (pinned where the parameter is on the card)."""
    shape = _moment_shape(mesh, shardings[name], v)
    if offload:
        return torch.zeros(shape, dtype=accum_dtype,
                           pin_memory=v.device.type == "cuda")
    return torch.zeros(shape, dtype=accum_dtype, device=v.device)


@torch.no_grad()
def apply_adamw(params: Dict[str, torch.Tensor], grads: list, opt_state,
                lr, beta1, beta2, eps, weight_decay,
                accum_dtype=torch.float32, offload=False, mesh=None):
    """One AdamW step of the train-step factories, IN PLACE: advance
    ``opt_state["step"]``, then ``adamw_update`` each tensor of
    ``params`` and its moments. ``grads`` is a list in ``params``' order;
    each entry is set to None once used, which frees it, and a None entry
    (a parameter the loss does not reach) leaves its tensor alone.

    ``offload``: the moments are host memory (``make_adamw_state(...,
    offload=True)``) and stream through the card in chunks of
    ``OFFLOAD_CHUNK`` tensors (``_apply_offloaded``). The update itself is
    the same operations on the same values, so the result is the same
    bits as with moments on the card."""
    opt_state["step"] += 1
    t = opt_state["step"].to(torch.float32)
    hyper = (lr, beta1, beta2, eps, weight_decay)
    dims = opt_state.get("dims")
    full = params
    if dims and any(d is not None for d in dims.values()):
        # ZeRO-1: the update runs on this rank's slices (copies), which
        # are then all-gathered into the parameters
        params = {k: (p if dims[k] is None
                      else _slice(mesh, dims[k], p).contiguous())
                  for k, p in params.items()}
        for i, k in enumerate(params):
            if dims[k] is not None and grads[i] is not None:
                grads[i] = _slice(mesh, dims[k], grads[i]).contiguous()
    if offload:
        _apply_offloaded(params, grads, opt_state, t, hyper, accum_dtype)
    else:
        for i, k in enumerate(params):
            if grads[i] is not None:
                _update_one(params, grads, i, k, opt_state["m"][k],
                            opt_state["v"][k], t, hyper, accum_dtype)
    if params is not full:
        from ...distributed.collective import all_gather
        group = mesh.group("sharding")
        for k, d in dims.items():
            if d is not None:
                full[k].copy_(torch.cat(all_gather([], params[k], group),
                                        dim=d))


def _apply_offloaded(params, grads, opt_state, t, hyper, accum_dtype):
    """The update over host-memory moments, chunk by chunk (the
    reference's in-jit offload, ``llama.py:664-699``). For each chunk of
    ``OFFLOAD_CHUNK`` tensors:

    1. its moments are copied host -> card (``non_blocking``) on a copy
       stream into one of two staging slots, while the card updates the
       chunk before;
    2. the update runs on the current stream once that copy's event has
       passed: ``adamw_update``, unchanged;
    3. the new moments are copied card -> host on a second copy stream
       once the update's event has passed;
    4. a slot takes the chunk after next only after the event of its last
       card -> host copy.

    So at most two chunks of moments are on the card at once. The current
    stream waits for the last copy before this returns: host moments read
    on the host are final once the card is synchronised.

    On the CPU the same loop runs over the same slots and offsets, the
    slots in host memory. There are no streams or events there: each
    stream is None, which ``torch.cuda.stream`` takes as no stream, and
    each event None, so every copy and update runs in program order.
    (The reference's CPU lowering stages all the moments at once around
    the step, ``llama.py:701-737``; the values are the same.)"""
    m_host, v_host = opt_state["m"], opt_state["v"]
    keys = list(params)
    chunks = [list(enumerate(keys))[j:j + OFFLOAD_CHUNK]
              for j in range(0, len(keys), OFFLOAD_CHUNK)]
    dev = params[keys[0]].device
    cuda = dev.type == "cuda"
    compute = h2d = d2h = None
    if cuda:
        compute = torch.cuda.current_stream(dev)
        h2d, d2h = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
        h2d.wait_stream(compute)

    def record(stream):
        return stream.record_event() if cuda else None

    def wait(stream, event):
        if event is not None:
            stream.wait_event(event)

    slot_numel = max(sum(params[k].numel() for _, k in c) for c in chunks)
    slots = [torch.empty((2, slot_numel), dtype=accum_dtype, device=dev)
             for _ in range(2)]
    freed = [None, None]     # event: a slot's last card -> host copy ended

    def fetch(ci):
        """Chunk ``ci``'s moments copied into its slot: ({key: (m, v)},
        the event of the copies)."""
        s = ci % 2
        staged, off = {}, 0
        with torch.cuda.stream(h2d):
            wait(h2d, freed[s])
            for _, k in chunks[ci]:
                n, shape = params[k].numel(), params[k].shape
                m = slots[s][0, off:off + n].view(shape)
                v = slots[s][1, off:off + n].view(shape)
                m.copy_(m_host[k], non_blocking=cuda)
                v.copy_(v_host[k], non_blocking=cuda)
                staged[k] = (m, v)
                off += n
            return staged, record(h2d)

    pending = fetch(0)
    for ci, chunk in enumerate(chunks):
        staged, ready = pending
        if ci + 1 < len(chunks):
            pending = fetch(ci + 1)
        wait(compute, ready)
        for i, k in chunk:
            if grads[i] is not None:
                _update_one(params, grads, i, k, *staged[k], t, hyper,
                            accum_dtype)
        updated = record(compute)
        with torch.cuda.stream(d2h):
            wait(d2h, updated)
            for _, k in chunk:
                m_host[k].copy_(staged[k][0], non_blocking=cuda)
                v_host[k].copy_(staged[k][1], non_blocking=cuda)
            freed[ci % 2] = record(d2h)
    if cuda:
        # the slots go back to the allocator on the current stream: every
        # use of them on the copy streams must come before
        compute.wait_stream(d2h)


def make_adamw_state(params: Dict[str, torch.Tensor],
                     accum_dtype=torch.float32, offload=False, mesh=None,
                     shardings=None):
    """{"step": int32 scalar, "m": {k: zeros}, "v": {k: zeros}}, each
    moment in ``accum_dtype`` on its parameter's device.

    ``offload``: the moments live in host memory instead, pinned where the
    parameters are on the card (the reference's ``pinned_host`` memory
    kind), as views of one host block per moment: the pinned allocator
    rounds every block up to a power of two, so one block a moment wastes
    least. ``apply_adamw(..., offload=True)`` streams them.

    ``mesh`` and ``shardings`` ({key: spec}; ``params`` this rank's
    shards): under a "sharding" axis of several ranks each moment is the
    slice ``zero_like_sharded`` keeps, and ``"dims"`` ({key: the sliced
    dimension or None}) tells ``apply_adamw``."""
    dev = next(iter(params.values())).device
    state = {"step": torch.zeros((), dtype=torch.int32, device=dev)}
    sharded = mesh is not None and mesh.shape.get("sharding", 1) > 1
    shapes = {k: p.shape for k, p in params.items()}
    if sharded:
        state["dims"] = {k: moment_dim(mesh, shardings[k], p)
                         for k, p in params.items()}
        shapes = {k: _moment_shape(mesh, shardings[k], p)
                  for k, p in params.items()}
    if not offload:
        for name in ("m", "v"):
            state[name] = {k: torch.zeros(shapes[k], dtype=accum_dtype,
                                          device=v.device)
                           for k, v in params.items()}
        return state
    total = sum(s.numel() for s in shapes.values())
    for name in ("m", "v"):
        block = torch.zeros(total, dtype=accum_dtype,
                            pin_memory=dev.type == "cuda")
        views, off = {}, 0
        for k, shape in shapes.items():
            n = shape.numel()
            views[k] = block[off:off + n].view(shape)
            off += n
        state[name] = views
    return state


def replay_generators(generators):
    """``context_fn`` for ``torch.utils.checkpoint`` (non-reentrant): the
    recomputation draws what the forward drew from ``generators``
    (``torch.Generator``s; each one once). The forward's context saves
    their states; the recomputation's sets them again and restores the
    states it found afterwards, as ``jax.checkpoint`` recomputes from the
    same keys."""
    gens = list({id(g): g for g in generators}.values())
    saved = []

    @contextlib.contextmanager
    def forward():
        saved[:] = [g.get_state() for g in gens]
        yield

    @contextlib.contextmanager
    def recompute():
        now = [g.get_state() for g in gens]
        for g, s in zip(gens, saved):
            g.set_state(s)
        try:
            yield
        finally:
            for g, s in zip(gens, now):
                g.set_state(s)

    return forward(), recompute()
