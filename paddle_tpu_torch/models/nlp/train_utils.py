"""The AdamW update and optimizer state of the port's train-step
factories.

Counterpart of ``paddle_tpu/models/nlp/train_utils.py:53-84``
(``adamw_update``, ``make_adamw_state``) on one device, with the
reference's host-memory moments (``make_adamw_state(offload=True)`` and
the chunked update of ``llama.py:652-737``). The ZeRO moment sharding
(``zero_like_sharded``) belongs to the distributed queue (ROADMAP
Queue 1).
"""
from __future__ import annotations

from typing import Dict

import torch

# tensors whose moments cross to the card together in an offloaded
# update: the reference's ``chunk_n`` (llama.py:676)
OFFLOAD_CHUNK = 4


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


def _update_one(params, grads, i, k, m, v, t, hyper, accum_dtype):
    """``adamw_update`` of tensor ``k`` (``grads[i]``) against the moments
    ``m`` and ``v``, all IN PLACE; the gradient is dropped once used."""
    new_p, m2, v2 = adamw_update(params[k], grads[i], m, v, t, *hyper,
                                 accum_dtype)
    grads[i] = None
    params[k].copy_(new_p)
    m.copy_(m2)
    v.copy_(v2)


@torch.no_grad()
def apply_adamw(params: Dict[str, torch.Tensor], grads: list, opt_state,
                lr, beta1, beta2, eps, weight_decay,
                accum_dtype=torch.float32, offload=False):
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
    if offload:
        _apply_offloaded(params, grads, opt_state, t, hyper, accum_dtype)
        return
    for i, k in enumerate(params):
        if grads[i] is not None:
            _update_one(params, grads, i, k, opt_state["m"][k],
                        opt_state["v"][k], t, hyper, accum_dtype)


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
                     accum_dtype=torch.float32, offload=False):
    """{"step": int32 scalar, "m": {k: zeros}, "v": {k: zeros}}, each
    moment in ``accum_dtype`` on its parameter's device.

    ``offload``: the moments live in host memory instead, pinned where the
    parameters are on the card (the reference's ``pinned_host`` memory
    kind), as views of one host block per moment: the pinned allocator
    rounds every block up to a power of two, so one block a moment wastes
    least. ``apply_adamw(..., offload=True)`` streams them."""
    dev = next(iter(params.values())).device
    state = {"step": torch.zeros((), dtype=torch.int32, device=dev)}
    if not offload:
        for name in ("m", "v"):
            state[name] = {k: torch.zeros(v.shape, dtype=accum_dtype,
                                          device=v.device)
                           for k, v in params.items()}
        return state
    total = sum(p.numel() for p in params.values())
    for name in ("m", "v"):
        block = torch.zeros(total, dtype=accum_dtype,
                            pin_memory=dev.type == "cuda")
        views, off = {}, 0
        for k, p in params.items():
            views[k] = block[off:off + p.numel()].view(p.shape)
            off += p.numel()
        state[name] = views
    return state
