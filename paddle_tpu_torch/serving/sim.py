"""Simulated paged decode factory: the scale harness for the serving
stack.

A real ``llama_serving_decode_factory`` prices a 10^5-request cluster
trace out of reach on CPU — every prefill and decode turn is a jitted
program call. The CLUSTER layer's claims, though, are about placement,
scheduling, drain/join bookkeeping and prefix-cache *routing*, none of
which need real logits: they need a decode backend whose tokens are a
deterministic function of the request's full token history **as read
back through the engine's own page tables**.

``SimServing`` is exactly that surface:

- the "KV pool" is one int array ``pools[page, offset]``; prefill
  writes the prompt's tokens through the page table (honoring the
  chunk-aligned ``resume_from`` prefix-cache skip — skipped positions
  must already hold the publisher's identical tokens), decode writes
  each input token at its position before emitting the next;
- there is ONE token rule: the next token after any history is a hash
  of the FULL pooled sequence, read back through the page table every
  step — so a wrong page table, a stale prefix chain, or a
  cross-replica pool mixup diverges the stream (the same failure
  surface the real backend has, at numpy speed);
- because prefill and decode apply the SAME rule to the same history,
  the sim is RESUME-CONSISTENT exactly like the real model: prefilling
  ``prompt + already_emitted`` yields the token a decode step would
  have emitted next. That is the property the fault-tolerance layer's
  resume-from-prefix retries stand on — a request failed over
  mid-decode re-enters with its emitted tokens as prompt and the
  completed stream must be token-identical to an uninterrupted run;
- tokens depend ONLY on the request's own history, so greedy parity
  across placement policies / replica counts / crash-failover retries
  / a single-engine oracle is the honest invariant it is with the
  real model.

``wants_numpy_`` tells the engine to skip the tensor staging
(``torch.as_tensor``; pure overhead here). Paged-only by design: build engines with
``policy="paged"``; the dense parts raise if a wave is ever routed
there.
"""
from __future__ import annotations

import numpy as np

_MUL = np.uint64(6364136223846793005)   # splitmix/LCG-grade odd mult


# the dense-introspection stub is SHARED with the TP factory
# (models.nlp.llama_decode.PagedOnlyDense) so the engine's dense
# surface has exactly one stub to keep in lockstep
_SIM_DENSE_REASON = (
    "SimServing is paged-only (policy='paged'): the sim validates "
    "paged bookkeeping at scale; route dense waves to a real "
    "factory")


class SimServing:
    """Drop-in ``serving=`` object for ``ServingEngine`` (paged only).

    ``vocab`` bounds emitted tokens to ``[1, vocab)`` (0 is the pool's
    padding value and never emitted); ``salt`` decorrelates two sims
    that should NOT agree (a negative control for parity tests).
    """

    wants_numpy_ = True
    # KVHandoff canonical-layout descriptor: exported chains are
    # (n_pages, page_size) token rows, not head-major tensor leaves
    kv_layout_ = "tokens"

    def __init__(self, *, max_len: int = 64, page_size: int = 8,
                 n_pool_pages: int | None = None, slots: int = 8,
                 vocab: int = 509, salt: int = 0,
                 chunked_prefill: int | None = None, tp=None,
                 lora_slots: int | None = None,
                 spec_accept: float | None = None,
                 kv_quant: str | None = None,
                 grammar_slots: int | None = None,
                 grammar_states: int = 64):
        if max_len % page_size:
            raise ValueError(f"max_len {max_len} must be a multiple of "
                             f"page_size {page_size}")
        # ``tp`` (TPConfig / int degree): the sim's TENSOR-PARALLEL
        # stand-in. The token pool stays ONE host array — the token
        # rule hashes full histories, there are no heads to split —
        # but the factory advertises the tp degree (``tp_``) and the
        # per-device byte arithmetic (``pool_device_bytes``: total /
        # size, exactly what a head-sharded pool measures), so the
        # ENGINE/CLUSTER tp machinery — paged-policy coercion, pool
        # byte census + gauge, handoff tp tags and placement filters —
        # runs at 10^5-request scale. Compute-sharding parity is the
        # real factory's claim, not the sim's.
        from ..models.nlp.llama_decode import (GrammarConfig,
                                               LoRAConfig,
                                               PagedOnlyDense,
                                               as_tp_config)
        self.tp_ = as_tp_config(tp)
        # ``lora_slots``: the sim's MULTI-ADAPTER stand-in. A real
        # adapter is a low-rank weight delta; the sim's is a per-slot
        # SALT folded into the token rule, so two adapters diverge
        # every stream while slot 0 (salt 0, the reserved identity)
        # emits exactly the base rule — the same observable contract
        # the real bank has, at numpy speed. The factory advertises
        # ``lora_`` plus the ``init_adapter_bank``/``upload_adapter``
        # hooks the engine's AdapterCache consumes; a delta set here
        # is ``{"salt": int}`` (or a bare int).
        self.lora_ = None if lora_slots is None \
            else LoRAConfig(n_slots=int(lora_slots), rank=1)
        # ``grammar_slots``: the sim's CONSTRAINED-DECODING stand-in.
        # The real factory masks logits with a packed per-state
        # allow-bitmask before its argmax; the sim's token rule picks
        # ``allowed[hash % len(allowed)]`` from the SAME unpacked bank
        # row — deterministic, and an all-allow row (flat id 0, the
        # identity every free row indexes) special-cases to EXACTLY
        # the base rule, so free rows are byte-identical to a
        # grammar-less sim. The factory advertises ``grammar_`` /
        # ``grammar_vocab_`` plus the ``init_grammar_bank``/
        # ``upload_grammar`` hooks the engine's GrammarCache consumes.
        self.grammar_ = None if grammar_slots is None \
            else GrammarConfig(n_slots=int(grammar_slots),
                               max_states=int(grammar_states))
        self.grammar_vocab_ = int(vocab)
        # ``kv_quant``: the sim's QUANTIZED-PAGE-TIER stand-in. The
        # token pool is lossless content (int64 tokens have no numerics
        # to degrade — greedy parity with the unquantized sim is EXACT,
        # which is precisely what makes the engine/cluster bookkeeping
        # testable at 10^5 scale), but the factory advertises the mode
        # (``kv_quant_``), per-page prices (``page_bytes_``: a
        # synthetic fp row vs an int8+scale row) and a no-op
        # ``compact_pages``, so the ENGINE machinery — stored-bytes
        # census, pressure incidents, compaction batches, handoff tier
        # tags — runs for real. Accuracy claims live with the real
        # factory.
        if kv_quant not in (None, "int8", "pressure"):
            raise ValueError(f"kv_quant {kv_quant!r}: use None, "
                             "'int8' or 'pressure'")
        self.kv_quant_ = kv_quant
        self.page_bytes_ = None if kv_quant is None else \
            (page_size * 8, page_size * 4 + 4)
        # the host-arena tier's full-precision per-page price,
        # advertised UNCONDITIONALLY (the int64 token pool is 8
        # bytes/token whether or not a quant tier is armed) — the
        # engine's hostmem= arming reads it so arena budgets price
        # identically with and without kv_quant
        self.page_host_bytes_ = page_size * 8
        self.dense = PagedOnlyDense(_SIM_DENSE_REASON)
        if vocab < 3:
            raise ValueError("vocab must be >= 3")
        if n_pool_pages is None:
            n_pool_pages = slots * (max_len // page_size) + 1
        self.max_len_ = max_len
        self.page_size_ = page_size
        self.n_pool_pages_ = n_pool_pages
        self.chunked_prefill_ = chunked_prefill or page_size
        if self.chunked_prefill_ % page_size:
            raise ValueError("chunked_prefill must be a page multiple")
        self.vocab = int(vocab)
        self.salt = int(salt)
        # wrapping-uint64 polynomial-hash powers, highest degree first
        # (built in python ints mod 2^64 — numpy warns on uint64
        # SCALAR overflow even though the wrap is exactly what we want)
        mul, mask = int(_MUL), (1 << 64) - 1
        p, acc = [], 1
        for _ in range(max_len):
            p.append(acc)
            acc = (acc * mul) & mask
        self._pow = np.asarray(p, np.uint64)
        pools = np.zeros((n_pool_pages, page_size), np.int64)
        self.paged_parts = (None, None, pools, self._make_prefill(),
                            None, self._make_decode_n())
        # the fused ragged-prefill entry point (the engine's
        # ragged_prefill= flag probes for this attribute), mirroring
        # the real factory's contract: one call runs ONE pending chunk
        # per row at per-row offsets, returning per-row first tokens
        # that are meaningful only for rows whose final chunk this is
        self.prefill_ragged = self._make_prefill_ragged()
        # ``spec_accept``: the sim's SPECULATIVE stand-in. The real
        # spec factory's draft is a second model whose proposals the
        # target verifies; the sim's draft proposes the TRUE next
        # token with this probability (decided by a second
        # deterministic hash of the same history, so acceptance
        # replays bit-identically) and a guaranteed-different token
        # otherwise. Verification is the real acceptance arithmetic —
        # emitted tokens are always the true rule's, so greedy parity
        # with plain decode is exact, and only TIMING (rounds per
        # token) depends on the draft. The factory then advertises
        # ``spec_parts`` shaped like the real one's; the draft "pool"
        # is a zero-size array (the sim's truth pool is the token
        # history itself, so the draft reads the same pool — the
        # page-chain sharing the model-side claim is about).
        self.spec_accept = None
        self.spec_parts = None
        if spec_accept is not None:
            if not 0.0 <= float(spec_accept) <= 1.0:
                raise ValueError("spec_accept is an acceptance "
                                 "probability in [0, 1]")
            self.spec_accept = float(spec_accept)
            self.spec_parts = (None, None,
                               np.zeros((0,), np.int64),
                               self._make_spec_prefill(),
                               self._make_spec_step())

    # --- the token rule ---------------------------------------------------
    def _hash(self, seq, adapter_salt: int = 0) -> int:
        """The salted uint64 wraparound polynomial hash of ``seq`` —
        the one source of randomness both token rules draw from."""
        seq = np.asarray(seq, np.uint64)
        L = len(seq)
        with np.errstate(over="ignore"):
            h = (seq * self._pow[L - 1::-1]).sum()
        return (int(h) + self.salt + int(adapter_salt)) \
            & ((1 << 64) - 1)

    def _token(self, seq, adapter_salt: int = 0) -> int:
        """THE greedy rule: next token after history ``seq`` = uint64
        wraparound polynomial hash of the whole sequence (deterministic
        on any platform), mapped to [1, vocab). Prefill applies it to
        the pooled prompt; every decode step applies it to the pooled
        prompt + emitted-so-far — one rule, so prefill and decode are
        RESUME-CONSISTENT (see the module docstring). ``adapter_salt``
        (multi-adapter serving) folds the row's adapter into the hash:
        salt 0 — slot 0, the identity — is EXACTLY the base rule."""
        return 1 + self._hash(seq, adapter_salt) % (self.vocab - 1)

    def _token_masked(self, seq, adapter_salt: int, allow) -> int:
        """The CONSTRAINED rule: the same hash picks among the mask
        row's allowed tokens. An all-allow row (the reserved flat id
        0 every free row indexes) is EXACTLY the base rule — free
        rows in a constrained wave stay byte-identical to
        ``grammar=None``. Mirrors the real factory's masked argmax:
        deterministic in (history, mask)."""
        allow = np.asarray(allow, bool)
        if allow.all():
            return self._token(seq, adapter_salt)
        allowed = np.nonzero(allow)[0]
        if len(allowed) == 0:
            raise ValueError("grammar mask allows no token (dead "
                             "state reached — engine bug)")
        return int(allowed[self._hash(seq, adapter_salt)
                           % len(allowed)])

    def _grammar_row(self, grammar, s: int):
        """Unpack row ``s`` of a ``(bank, gids)`` grammar payload to
        a (vocab,) bool allow vector; None without a payload or for
        flat id 0 fast-path handled by the caller via all-allow."""
        from .grammar import unpack_row
        bank, gids = grammar
        gid = int(np.asarray(gids)[s])
        return unpack_row(np.asarray(bank)[gid], self.vocab)

    def _draft_token(self, seq) -> int:
        """The sim DRAFT's proposal after history ``seq``: the true
        next token with probability ``spec_accept`` (a second
        deterministic hash of the same history decides, so two seeded
        replays accept identically), otherwise a token guaranteed to
        differ — which the verify arithmetic then rejects."""
        t = self._token(seq)
        seq_a = np.asarray(seq, np.uint64)
        L = len(seq_a)
        with np.errstate(over="ignore"):
            h = (seq_a * self._pow[L - 1::-1]).sum()
        h = (int(h) * 0x9E3779B97F4A7C15 + 0xD1B54A32D192ED03) \
            & ((1 << 64) - 1)
        u = (h >> 11) / float(1 << 53)
        if u < self.spec_accept:
            return t
        return 1 + (t % (self.vocab - 1))  # != t for vocab >= 3

    def _make_spec_prefill(self):
        """The sim draft's prefill: a no-op returning the (empty)
        draft pool — the sim's token rule derives every proposal from
        the TRUE pool content, so there is nothing to warm (the real
        factory's draft prefill writes draft K/V through the shared
        page chain)."""
        def spec_prefill(outer, layers, toks, pt, lens, pools,
                         resume_from: int = 0, lora=None):
            return np.zeros((1,), np.int64), pools

        spec_prefill._cache_size = lambda: 0
        return spec_prefill

    def _make_spec_step(self):
        ps = self.page_size_

        def spec_step(outer_t, layers_t, outer_d, layers_d, prev,
                      toks, pt, lens, pools, pools_d, k):
            """One batched speculative round, the real acceptance
            arithmetic at numpy speed: per active row, draft ``k``
            proposals (each conditioned on the draft's OWN walk, like
            the real draft cache), verify against the true rule,
            advance by accepted prefix + correction. The accepted
            true tokens land in the pool through the page table —
            wrong tables/chains diverge streams exactly like plain
            decode."""
            toks = np.asarray(toks)
            pt = np.asarray(pt)
            lens = np.asarray(lens)
            S = toks.shape[0]
            counts = np.zeros((S,), np.int64)
            cands = np.zeros((S, k + 1), np.int64)
            for s in range(S):
                L = int(lens[s])
                if L <= 0:
                    continue  # plain/empty slot rides along
                # this round's input token lands at position L first
                # (the verify block's write), then the history reads
                # back THROUGH the table
                pools[pt[s, L // ps], L % ps] = int(toks[s])
                npages = -(-(L + 1) // ps)
                hist = [int(x) for x in
                        pools[pt[s, :npages]].reshape(-1)[:L + 1]]
                drafts, truths = [], []
                h = list(hist)
                for i in range(k):
                    truths.append(self._token(h))
                    drafts.append(self._draft_token(h))
                    h.append(drafts[-1])
                truths.append(self._token(h))  # the bonus token
                n = 0
                while n < k and drafts[n] == truths[n]:
                    n += 1
                emitted = drafts[:n] + [truths[n]]
                counts[s] = n
                cands[s, :n + 1] = emitted
                # accepted TRUE tokens persist at L+1..L+n; the
                # correction token is the row's next input, written
                # by the NEXT round/turn — the decode_n discipline
                for j in range(n):
                    p = L + 1 + j
                    pools[pt[s, p // ps], p % ps] = emitted[j]
            return counts, cands, pools, pools_d

        spec_step._cache_size = lambda: 0
        return spec_step

    # --- adapter-bank hooks (AdapterCache's device seam) ------------------
    def init_adapter_bank(self):
        if self.lora_ is None:
            raise ValueError("SimServing built without lora_slots")
        return np.zeros((self.lora_.n_slots,), np.int64)

    @staticmethod
    def upload_adapter(bank, slot, deltas):
        salt = deltas["salt"] if isinstance(deltas, dict) else deltas
        bank[int(slot)] = int(salt)
        return bank

    # --- grammar-bank hooks (GrammarCache's device seam) ------------------
    def init_grammar_bank(self):
        """The packed allow-bitmask bank, sim edition: the SAME layout
        the real factory stages on device — ``(n_slots * max_states,
        ceil(vocab/32))`` uint32, slot 0 (flat ids ``0..max_states-1``)
        all-ones so free rows index the reserved all-allow identity —
        just host numpy (``wants_numpy_``)."""
        if self.grammar_ is None:
            raise ValueError("SimServing built without grammar_slots")
        ns, ms = self.grammar_.n_slots, self.grammar_.max_states
        words = (self.vocab + 31) // 32
        bank = np.zeros((ns * ms, words), np.uint32)
        bank[:ms] = np.uint32(0xFFFFFFFF)
        return bank

    def upload_grammar(self, bank, slot, compiled):
        """Write a compiled automaton's per-state masks into its slot's
        block (zero-padding unused state rows — a stale mask from the
        evicted tenant must never leak into a shorter successor)."""
        ms = self.grammar_.max_states
        n = int(compiled.n_states)
        if n > ms:
            raise ValueError(f"automaton has {n} states but the bank "
                             f"holds max_states={ms}")
        lo = int(slot) * ms
        bank[lo:lo + ms] = 0
        bank[lo:lo + n] = np.asarray(compiled.masks, np.uint32)
        return bank

    # --- the factory callables --------------------------------------------
    def _make_prefill(self):
        ps = self.page_size_
        C = self.chunked_prefill_

        def prefill(outer, layers, toks, pt, lens, pools,
                    resume_from: int = 0, lora=None, grammar=None):
            toks = np.asarray(toks)
            pt = np.asarray(pt)
            L = int(np.asarray(lens)[0])
            T = toks.shape[1]
            # the real factory clamps resume so the FINAL chunk always
            # runs (the last-position logits must exist)
            resume = min(int(resume_from), T - C)
            resume = max(resume, 0)
            for pos in range(resume, L):
                pools[pt[0, pos // ps], pos % ps] = toks[0, pos]
            pages = pt[0, :-(-L // ps)]
            seq = pools[pages].reshape(-1)[:L]
            a_salt = 0
            if lora is not None:
                bank, ids = lora
                a_salt = int(np.asarray(bank)[int(np.asarray(ids)[0])])
            if grammar is not None:
                first = self._token_masked(
                    seq, a_salt, self._grammar_row(grammar, 0))
            else:
                first = self._token(seq, a_salt)
            return np.asarray([first], np.int64), pools

        prefill._cache_size = lambda: 0  # no jit cache to watch
        return prefill

    def _make_prefill_ragged(self):
        ps = self.page_size_

        def prefill_ragged(outer, layers, chunk, starts, pt, lens,
                           pools, lora=None, grammar=None):
            """The real factory's fused lane dispatch, sim edition:
            row r writes the C tokens of ``chunk[r]`` at absolute
            positions ``starts[r]..`` through its own page table, then
            rows whose length-1 position falls inside the window (the
            row's FINAL chunk) hash their full pooled history into the
            first token. Idle rows (the engine points them at page 0)
            write garbage there, the pool convention."""
            chunk = np.asarray(chunk)
            starts = np.asarray(starts)
            pt = np.asarray(pt)
            lens = np.asarray(lens)
            R, C = chunk.shape
            bank = ids = None
            if lora is not None:
                bank, ids = lora
                bank, ids = np.asarray(bank), np.asarray(ids)
            firsts = np.zeros((R,), np.int64)
            for s in range(R):
                L = int(lens[s])
                st = int(starts[s])
                for pos in range(st, min(st + C, L)):
                    pools[pt[s, pos // ps], pos % ps] = \
                        chunk[s, pos - st]
                if not (st <= L - 1 < st + C):
                    continue  # mid-prompt row: no logits to harvest
                pages = pt[s, :-(-L // ps)]
                seq = pools[pages].reshape(-1)[:L]
                a_salt = int(bank[int(ids[s])]) if bank is not None \
                    else 0
                if grammar is not None:
                    firsts[s] = self._token_masked(
                        seq, a_salt, self._grammar_row(grammar, s))
                else:
                    firsts[s] = self._token(seq, a_salt)
            return firsts, pools

        prefill_ragged._cache_size = lambda: 0
        return prefill_ragged

    def _make_decode_n(self):
        ps = self.page_size_

        def decode_n(outer, layers, toks, pt, lens, pools, n: int,
                     lora=None, grammar=None):
            toks = np.asarray(toks)
            pt = np.asarray(pt)
            lens = np.asarray(lens)
            S = toks.shape[0]
            bank = ids = None
            if lora is not None:
                bank, ids = lora
                bank, ids = np.asarray(bank), np.asarray(ids)
            emits = np.zeros((n, S), np.int64)
            for s in range(S):
                L = int(lens[s])
                if L <= 0:
                    continue  # empty slot rides along (page-0 row)
                a_salt = int(bank[int(ids[s])]) if bank is not None \
                    else 0
                # grammar ids are DISPATCH-TIME state (advanced
                # host-side), so every scanned step masks with the
                # same row — the engine clamps n=1 for constrained
                # waves, exactly like the real factory's decode_n
                g_allow = None if grammar is None \
                    else self._grammar_row(grammar, s)
                cur = int(toks[s])
                for k in range(n):
                    pools[pt[s, L // ps], L % ps] = cur
                    # read the FULL history back through the table —
                    # a wrong table/chain/pool diverges every token
                    npages = -(-(L + 1) // ps)
                    seq = pools[pt[s, :npages]].reshape(-1)[:L + 1]
                    if g_allow is not None:
                        cur = self._token_masked(seq, a_salt, g_allow)
                    else:
                        cur = self._token(seq, a_salt)
                    emits[k, s] = cur
                    L += 1
            return emits, None, pools

        decode_n._cache_size = lambda: 0
        return decode_n

    def pool_total_bytes(self, pools) -> int:
        """The pool's byte footprint as STORED: the sim's token pool
        is physically int64 whatever the codec, so under
        kv_quant='int8' the price is the advertised int8+scale row
        cost, not the host array's nbytes — the arithmetic the real
        int8 factory gets for free from its int8 leaves."""
        if self.kv_quant_ == "int8":
            return self.n_pool_pages_ * self.page_bytes_[1]
        return int(np.asarray(pools).nbytes)

    def pool_device_bytes(self, pools) -> int:
        """One device's share of the pool under the advertised tp
        degree (the engine's per-device byte census hook)."""
        size = self.tp_.size if self.tp_ is not None else 1
        return self.pool_total_bytes(pools) // size

    @staticmethod
    def compact_pages(pools, mask):
        """Pressure-tier compaction, sim edition: token content is
        lossless so the pool is untouched — the BOOKKEEPING (tier
        sets, stored-bytes census, compaction counters) is what the
        engine exercises here."""
        return pools

    # --- KV handoff data plane ---------------------------------------------
    @staticmethod
    def export_kv_pages(pools, ids):
        """Copy the pool rows of ``ids`` for a KV handoff (the sim's
        "KV" is the token content itself, so a handoff moves exactly
        what decode reads back through the page table — a wrong chain
        or a dropped page diverges the stream like the real model)."""
        return pools[np.asarray(ids, np.int64)].copy()

    @staticmethod
    def import_kv_pages(pools, ids, data):
        """Scatter exported page content into this pool at ``ids``
        (the importer's freshly allocated chain)."""
        pools[np.asarray(ids, np.int64)] = data
        return pools

    # --- heterogeneous-handoff transforms (reshard-on-import) --------------
    @staticmethod
    def reshard_kv_pages(data):
        """The sim's token pool is ONE host array whatever tp degree
        it advertises (there are no heads to split), so gathering the
        chain into the canonical layout is the identity — the PRICED
        step still runs, which is exactly what the 10^5-scale hetero
        bookkeeping needs."""
        return data

    @staticmethod
    def repage_kv_pages(data, page_size_from, page_size_to, n_tokens):
        """Refold an exported ``(n_pages, page_size_from)`` token
        chain to the destination geometry: tokens are packed in chain
        order, pad slots return to 0 (the pool padding value a direct
        prefill leaves in its last page's slack)."""
        n_to = -(-int(n_tokens) // int(page_size_to))
        flat = np.asarray(data).reshape(-1)[:n_tokens]
        out = np.zeros((n_to * int(page_size_to),), flat.dtype)
        out[:n_tokens] = flat
        return out.reshape(n_to, int(page_size_to))

    @staticmethod
    def transcode_kv_pages(data, quant_from, quant_to):
        """Codec transcode, sim edition: int64 token content is
        lossless under every codec, so the data is untouched — the
        BOOKKEEPING (priced span, tier mirror via ``quant_pages``,
        stored-bytes census) is what the engine exercises."""
        if quant_from is not None:
            raise ValueError(
                f"transcode: source codec {quant_from!r} is not "
                "transcodable (only full-precision chains re-encode)")
        return data

    # --- the offline oracle -----------------------------------------------
    def expected_stream(self, prompt, n_tokens: int,
                        adapter_salt: int = 0, grammar=None):
        """The token stream a request with ``prompt`` generates,
        computed WITHOUT any engine — the closed-form oracle parity
        tests compare engine outputs against. (The engine path reads
        these same values back through page tables; this path replays
        the recurrence directly.) Resume identity falls out of the one
        token rule: ``expected_stream(prompt + s[:e], n-e)`` equals
        ``expected_stream(prompt, n)[e:]`` for any emitted prefix
        ``s = expected_stream(prompt, n)``. ``adapter_salt`` is the
        request's adapter (0 = base model). ``grammar`` — a
        ``CompiledGrammar`` — walks the automaton exactly like the
        engine: each emission is the constrained rule under the
        current state's mask, the state advances on the emitted
        token, and the stream STOPS at an accepting state (shorter
        than ``n_tokens`` when the automaton accepts first)."""
        from .grammar import unpack_row
        hist = [int(t) for t in prompt]
        out = []
        state = None if grammar is None else grammar.start
        for _ in range(max(0, n_tokens)):
            if grammar is None:
                nxt = self._token(hist, adapter_salt)
            else:
                allow = unpack_row(grammar.masks[state], self.vocab)
                nxt = self._token_masked(hist, adapter_salt, allow)
                state = grammar.step(state, nxt)
            out.append(nxt)
            hist.append(nxt)
            if grammar is not None and grammar.accepts_at(state):
                break
        return out


def make_sim_serving(**kw) -> SimServing:
    """Convenience constructor mirroring the real factory's signature
    style: ``make_sim_serving(max_len=64, page_size=8, slots=8, ...)``."""
    return SimServing(**kw)
