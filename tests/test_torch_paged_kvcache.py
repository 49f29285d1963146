"""The port's host page bookkeeper (paddle_tpu_torch.ops.PagedKVCache)
against the JAX package's: the same sequence of allocate / acquire_prefix /
register_prefix / free / eviction / write on both gives equal tables,
lengths, free lists, populations and ``cache_stats()`` after every step,
and equal pool contents after the writes (f32, exact: ``write`` only
copies)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import PagedKVCache as JaxBook
from paddle_tpu_torch.ops import PagedKVCache as TorchBook

PS, PAGES, HKV, HD = 4, 12, 2, 3


def _books():
    return (JaxBook(PAGES, PS, HKV, HD, dtype=jnp.float32),
            TorchBook(PAGES, PS, HKV, HD, dtype=torch.float32, device="cpu"))


def _state(book):
    return {"tables": {k: list(v) for k, v in book.tables.items()},
            "lengths": dict(book.lengths), "free": list(book._free),
            "evictable": list(book._evictable),
            "populations": book.populations(),
            "census_ok": book.census_ok(), "stats": book.cache_stats(),
            "holders": book.page_holders()}


def _both(books, name, *args):
    """Call ``name`` on both books; results (or the exception type) and
    the whole bookkeeping state must agree."""
    outs = []
    for book in books:
        try:
            outs.append(("ok", getattr(book, name)(*args)))
        except (MemoryError, ValueError) as e:
            outs.append(("raised", type(e).__name__))
    assert outs[0] == outs[1], (name, args, outs)
    assert _state(books[0]) == _state(books[1]), (name, args)
    return outs[0]


def test_scripted_prefix_sharing_and_eviction():
    books = _books()
    shared = list(range(1, 9))                       # two full pages
    _both(books, "allocate", "a", 10)
    _both(books, "register_prefix", "a", shared + [50, 51])
    assert _both(books, "match_prefix", shared + [7]) == ("ok", 8)
    assert _both(books, "acquire_prefix", "b", shared + [60]) == ("ok", 8)
    _both(books, "allocate", "b", 12)
    _both(books, "free", "a")
    _both(books, "free", "b")                        # shared pages park
    assert books[1].cache_stats()["evictable_pages"] == 2
    # fill the free list so the next allocation must evict leaf-first
    _both(books, "allocate", "c", 4 * (len(books[1]._free)))
    _both(books, "allocate", "d", 4)                 # evicts one leaf
    assert books[1].cache_stats()["evictions"] == 1
    _both(books, "allocate", "e", 40)                # MemoryError, no change
    assert _both(books, "acquire_prefix", "f", shared) == ("ok", 4)
    _both(books, "allocate", "f", 400)               # fails -> roll back
    _both(books, "rollback_acquire", "f", shared)
    _both(books, "acquire_prefix", "c", shared)      # ValueError: holds pages
    for sid in ("c", "d"):
        _both(books, "free", sid)
    assert books[1].census_ok()


@pytest.mark.parametrize("seed", range(6))
def test_random_op_sequences_agree(seed):
    """Random admissions from a small token alphabet (so prefixes recur),
    with acquire -> allocate -> rollback on refusal, register after the
    'prefill', frees in random order."""
    rng = np.random.default_rng(seed)
    books = _books()
    live, n = [], 0
    for _ in range(60):
        if live and rng.random() < 0.4:
            sid = live.pop(int(rng.integers(len(live))))
            _both(books, "free", sid)
            continue
        sid, n = f"s{n}", n + 1
        toks = rng.integers(1, 3, int(rng.integers(1, 14))).tolist()
        status, _ = _both(books, "acquire_prefix", sid, toks)
        status, _ = _both(books, "allocate", sid,
                          len(toks) + int(rng.integers(0, 6)))
        if status == "raised":
            _both(books, "rollback_acquire", sid, toks)
            continue
        _both(books, "register_prefix", sid, toks)
        live.append(sid)
    assert books[1].census_ok()


def test_write_fills_the_same_slots():
    books = _books()
    rng = np.random.default_rng(0)
    for sid, T in (("a", 3), ("b", 6), ("a", 7), ("b", 1)):
        k = rng.normal(0, 1, (HKV, T, HD)).astype(np.float32)
        v = rng.normal(0, 1, (HKV, T, HD)).astype(np.float32)
        jk, jv = books[0].write(sid, jnp.asarray(k), jnp.asarray(v))
        tk, tv = books[1].write(sid, torch.from_numpy(k),
                                torch.from_numpy(v))
        assert tk is books[1].k_pages and tv is books[1].v_pages  # in place
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert _state(books[0]) == _state(books[1])
    jt, jl = books[0].batch_views(["a", "b"])
    tt, tl = books[1].batch_views(["a", "b"])
    assert tt.dtype == tl.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
