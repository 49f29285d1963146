"""Continuous-batching Llama serving over the paged KV pool — the PyTorch
port of ``examples/serve_paged_llama.py``.

Requests ENTER and LEAVE the batch mid-stream: a finished sequence's pages
return to the pool and the next request reuses them at once. Every decode
step has the same shape whatever the mix of request depths: empty slots
ride along as pad rows with length 0 and a table of zeros, writing into
the reserved page 0 that real requests never use.

``serve`` is the loop; ``main`` runs it at the reference example's tiny
configuration:

    python -m paddle_tpu_torch.examples.serve_paged_llama [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

PS, POOL, WIDTH = 8, 24, 4   # page size, pool pages, table width


def _tokens(out):
    """Greedy tokens from a factory output: tokens as they are, logits
    (emit="logits") by argmax."""
    return (out if out.dim() == 1 else out.argmax(-1)).tolist()


def serve(outer, layers, pools, prefill, decode, book, requests, slots,
          width, pad_to=None, log=print):
    """Serve ``requests`` [(sid, prompt tokens, new-token budget)] in
    arrival order through ``slots`` decode slots. Each admitted request
    gets ``width`` pages, its prompt is padded to a multiple of ``pad_to``
    (default: the page size) and prefilled alone; then fixed-shape
    (slots, width) decode steps run until every request is done.

    Returns {"done": {sid: tokens}, "steps": decode steps,
    "prefill_s": [...], "decode_s": [...], "pools": pools}; the times are
    host-clock seconds of each call up to its tokens reaching the host."""
    ps = book.page_size
    pad_to = pad_to or ps
    dev = book.device
    waiting = list(requests)
    active, done = {}, {}
    prefill_s, decode_s = [], []
    state = {"pools": pools}

    def admit():
        while waiting and len(active) < slots:
            sid, prompt, budget = waiting.pop(0)
            try:
                book.allocate(sid, width * ps)
            except MemoryError:
                waiting.insert(0, (sid, prompt, budget))
                return
            T = pad_to * (-(-len(prompt) // pad_to))
            toks = np.zeros((1, T), np.int64)
            toks[0, :len(prompt)] = prompt
            book.lengths[sid] = len(prompt)
            pt, ln = book.batch_views([sid])
            t0 = time.perf_counter()
            nxt, state["pools"] = prefill(outer, layers,
                                          torch.from_numpy(toks).to(dev),
                                          pt, ln, state["pools"])
            first = _tokens(nxt)[0]
            prefill_s.append(time.perf_counter() - t0)
            # the prefill already produced token 1 of the budget
            active[sid] = {"tok": first, "left": budget - 1,
                           "out": [first]}
            if log:
                log(f"admit {sid}: prompt {len(prompt)} toks, "
                    f"budget {budget}, pages {book.tables[sid]}")

    admit()
    step = 0
    while active or waiting:
        if not active:
            raise RuntimeError(
                f"pool too small for any waiting request "
                f"({len(waiting)} waiting, {len(book._free)} pages free)")
        step += 1
        sids = sorted(active)
        pt_live, ln_live = book.batch_views(sids)
        assert pt_live.shape[1] == width
        pad = slots - len(sids)
        pt = torch.cat([pt_live, torch.zeros((pad, width), dtype=torch.int32,
                                             device=dev)])
        ln = torch.cat([ln_live, torch.zeros((pad,), dtype=torch.int32,
                                             device=dev)])
        toks = torch.tensor([active[s]["tok"] for s in sids] + [0] * pad,
                            device=dev)
        t0 = time.perf_counter()
        nxt, state["pools"] = decode(outer, layers, toks, pt, ln,
                                     state["pools"])
        nxt = _tokens(nxt)
        decode_s.append(time.perf_counter() - t0)
        for i, s in enumerate(sids):
            book.lengths[s] += 1
            active[s]["tok"] = nxt[i]
            active[s]["out"].append(nxt[i])
            active[s]["left"] -= 1
            if active[s]["left"] <= 0:
                done[s] = active.pop(s)["out"]
                freed = list(book.tables[s])
                book.free(s)
                if log:
                    log(f"step {step}: {s} done "
                        f"({len(done[s])} tokens), freed pages {freed}")
        admit()
    return {"done": done, "steps": step, "prefill_s": prefill_s,
            "decode_s": decode_s, "pools": state["pools"]}


def tiny_requests(seed: int = 0, n: int = 6, vocab: int = 96):
    """The reference example's request mix, from the same numpy seed."""
    rng = np.random.default_rng(seed)
    return [(f"req{i}", rng.integers(1, vocab, rng.integers(3, 8)).tolist(),
             int(rng.integers(4, 9))) for i in range(n)]


def main(device=None, state_dict=None):
    from ..models.nlp import (LlamaConfig, LlamaForCausalLM,
                              llama_paged_decode_factory,
                              load_numpy_state_dict)
    from ..ops import PagedKVCache

    model = LlamaForCausalLM(LlamaConfig.tiny(vocab=96, hidden=32, layers=2,
                                              heads=4, kv_heads=2),
                             device=device, seed=0)
    if state_dict is not None:
        load_numpy_state_dict(model, state_dict)
    outer, layers, pools, prefill, decode, _ = llama_paged_decode_factory(
        model, page_size=PS, n_pool_pages=POOL, device=device)
    book = PagedKVCache(POOL, PS, kv_heads=2, head_dim=8,
                        dtype=torch.float32, device=device)
    res = serve(outer, layers, pools, prefill, decode, book, tiny_requests(),
                slots=2, width=WIDTH)
    print(f"served {len(res['done'])} requests in {res['steps']} decode "
          f"steps (batch slots: 2, pool: {POOL} pages)")
    assert len(res["done"]) == 6
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    main(ap.parse_args().device)
