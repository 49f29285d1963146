"""The continuous-batching loop of ``examples/serve_paged_llama.py`` run
through the port (``paddle_tpu_torch.examples.serve_paged_llama``, CPU)
against the JAX example itself, at the example's tiny configuration and
seed, on the same weights: every prefill and decode call returns the same
tokens, so the token streams, admissions, page assignments and frees, as
both print them, are identical."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu.models.nlp as jax_nlp
import paddle_tpu_torch.models.nlp as torch_nlp
from paddle_tpu_torch.examples import serve_paged_llama as torch_example

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / \
    "serve_paged_llama.py"


def _recording(factory, calls, state=None):
    """Wrap a paged decode factory so every prefill / decode call records
    its emitted tokens (and, for the JAX one, capture the model's
    weights)."""
    def wrapped(model, *args, **kw):
        if state is not None:
            state.update({k: np.asarray(v._value)
                          for k, v in model.state_dict().items()})
        outer, layers, pools, prefill, decode, dn = factory(model, *args,
                                                            **kw)

        def rec(kind, fn):
            def call(*a, **k):
                out, pools = fn(*a, **k)
                calls.append((kind, np.asarray(out).tolist()))
                return out, pools
            return call
        return (outer, layers, pools, rec("prefill", prefill),
                rec("decode", decode), dn)
    return wrapped


def test_port_serves_the_same_streams(monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location("jax_serve_example",
                                                  EXAMPLE)
    jax_example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_example)

    jax_calls, torch_calls, state = [], [], {}
    monkeypatch.setattr(jax_nlp, "llama_paged_decode_factory",
                        _recording(jax_nlp.llama_paged_decode_factory,
                                   jax_calls, state))
    jax_example.main()
    jax_log = capsys.readouterr().out.splitlines()

    monkeypatch.setattr(torch_nlp, "llama_paged_decode_factory",
                        _recording(torch_nlp.llama_paged_decode_factory,
                                   torch_calls))
    res = torch_example.main(device="cpu", state_dict=state)
    torch_log = capsys.readouterr().out.splitlines()

    assert len(jax_calls) > 6 and jax_calls == torch_calls
    assert torch_log == jax_log
    assert sum(len(t) for t in res["done"].values()) == sum(
        n for _, _, n in torch_example.tiny_requests())


def test_example_requests_are_the_reference_mix():
    """The port's request generator draws what the JAX example draws."""
    rng = np.random.default_rng(0)
    want = [(f"req{i}", rng.integers(1, 96, rng.integers(3, 8)).tolist(),
             int(rng.integers(4, 9))) for i in range(6)]
    assert torch_example.tiny_requests() == want


def test_serve_refuses_a_pool_too_small():
    """A request that can never be placed raises instead of spinning."""
    from paddle_tpu_torch.models.nlp import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import PagedKVCache

    cfg = LlamaConfig.tiny(vocab=32, hidden=16, layers=1, heads=2,
                           kv_heads=1)
    model = LlamaForCausalLM(cfg, device="cpu")
    outer, layers, pools, prefill, decode, _ = \
        torch_nlp.llama_paged_decode_factory(model, page_size=4,
                                             n_pool_pages=3, device="cpu")
    book = PagedKVCache(3, 4, kv_heads=1, head_dim=8, dtype=cfg.dtype,
                        device="cpu")
    with pytest.raises(RuntimeError, match="pool too small"):
        torch_example.serve(outer, layers, pools, prefill, decode, book,
                            [("r", [1, 2, 3], 2)], slots=1, width=4,
                            log=None)
