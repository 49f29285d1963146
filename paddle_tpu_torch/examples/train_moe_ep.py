"""Expert-parallel MoE pretraining on a {data 2, expert 4} mesh of
processes: ``moe_train_step_factory(model, mesh=build_mesh(...))`` over
``MoEForCausalLM``, one process a rank over gloo.

The counterpart of ``examples/train_moe_ep.py``: the same 2-layer config
(16 fine-grained routed experts top-2 beside one shared expert), 8 steps
of fresh (4, 65)-token global batches at lr 5e-3. Each rank holds its 4
of the 16 experts (the expert shard fraction 0.25), routes its data
rank's rows of every batch globally, runs only its own experts and sums
the partial outputs over "expert" (``MoELayer.distribute``); gradients
are averaged over "data". The ranks run on the card unless the CPU is
asked for (``--device cpu``; on the card every rank takes the card of its
rank modulo the cards, the collectives over gloo; without a card the
default raises). ``--repeat`` trains on the first
batch at every step, where the loss falls (random tokens leave nothing
to learn from fresh batches but their uniform distribution):

    python -m paddle_tpu_torch.examples.train_moe_ep
    python -m paddle_tpu_torch.examples.train_moe_ep --data 2 --expert 2
    python -m paddle_tpu_torch.examples.train_moe_ep --device cpu
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import tempfile

import numpy as np
import torch

from paddle_tpu_torch import distributed as D
from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.examples.train_moe import EP_EXAMPLE


def _rank(dims, steps, device, repeat, out):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.nlp import (MoEConfig, MoEForCausalLM,
                                             moe_train_step_factory)
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(int(os.environ["PADDLE_TRAINER_ID"])
                              % torch.cuda.device_count())
    paddle.set_device(device)
    D.init_parallel_env(backend="gloo",
                        timeout=datetime.timedelta(seconds=120))
    mesh = D.build_mesh(dims)
    cfg = MoEConfig(**EP_EXAMPLE)
    dev = paddle.resolve_device(None)
    model = MoEForCausalLM(cfg, device=dev, seed=0)
    params, opt_state, step = moe_train_step_factory(
        model, mesh, learning_rate=5e-3, device=dev)
    # the expert weights really are this rank's share
    w = params["layers.0.mlp.w_in"]
    frac = w.numel() / (cfg.num_experts * cfg.hidden_size
                        * cfg.intermediate_size)
    rank = D.get_rank()
    if rank == 0:
        print(f"expert shard fraction: {frac:.3f} "
              f"(expect {1 / dims['expert']:.3f})")
    rng = np.random.default_rng(0)
    losses = []
    for it in range(steps):
        if it == 0 or not repeat:
            tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 65)))
        params, opt_state, loss = step(params, opt_state, tok[:, :-1],
                                       tok[:, 1:])
        losses.append(float(loss))
        if rank == 0:
            print(f"step {it}: loss {losses[-1]:.4f}")
    if rank == 0 and out:
        with open(out, "w") as f:
            json.dump({"shard_fraction": frac, "losses": losses}, f)
    D.barrier()
    D.destroy_process_group()


def main(argv=None):
    """Train on the mesh; returns {"shard_fraction", "losses"} (rank 0's:
    the loss is the global batch's on every rank)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--expert", type=int, default=4)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--repeat", action="store_true",
                    help="the first batch at every step")
    args = ap.parse_args(argv)
    dims = {"data": args.data, "expert": args.expert}
    device = resolve_device(args.device).type
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.json")
        D.spawn(_rank, (dims, args.steps, device, args.repeat, out),
                nprocs=args.data * args.expert,
                init_method=f"file://{os.path.join(tmp, 'store')}")
        with open(out) as f:
            return json.load(f)


if __name__ == "__main__":
    main()
