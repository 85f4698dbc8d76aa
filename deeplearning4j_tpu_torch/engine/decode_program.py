"""DecodeProgram: the device half of continuous-batching decode, over a
PAGED KV virtual address space (counterpart of
deeplearning4j_tpu/engine/decode_program.py).

One model's autoregressive programs, each built ONCE per shape and
never again (pinned by the model's JitCache build counters, which a
call with shapes off the program's key moves):

  decode step   ONE program over the engine's fixed [max_slots] batch:
                consume each slot's current token at its current
                LOGICAL position, scatter that position's K/V into a
                host-chosen (page, offset) write cell, gather each
                slot's attention window through per-cell
                (page, offset) index arrays in logical token order,
                attend under per-slot live masks, emit each slot's
                greedy next token. Joins, leaves, shared prefix pages,
                copy-on-write forks and ring wrap past max_ctx are all
                DATA (the host page table); the shapes never change.
  chunk prefill ONE program per page_size chunk: one page-aligned slice
                of a prompt in parallel — causal within the chunk,
                attending to the prior context through the same
                gathered-cell indirection — parking its K/V in one
                physical page.
  page copy     the copy-on-write primitive: duplicate one physical
                page (all layers, K and V) inside the pool.

Physical pool layout: ONE preallocated f32 tensor
``[n_layers, 2, n_pages, n_heads, page_size, head_dim]`` — page-major
so one page id addresses every layer's K and V rows at once, HEAD-MAJOR
within a page so gathered cells arrive [..., n_heads, cells, head_dim],
head_dim innermost. Page 0 is SCRATCH: the write target for inactive
or suppressed rows and the gather target for dead cells — never mapped
live; the attention primitives zero its bytes before any contraction.

The programs run eagerly and update the pool IN PLACE, scatter before
gather, and return the same tensor: `kv = prog.step(kv, ...)` reads as
it does in the JAX package (whose programs donate the pool), and every
pool — the engine's, the oracle's, a bench arm's — stays its own
tensor.

Host inputs of a call (tokens, positions, cell and write arrays) travel
in ONE host-to-device copy from a pinned staging buffer. The step's
only device-to-host read is the caller's: `host_outputs(nxt, ok)` reads
the [S] tokens and finite verdicts together.

Bitwise contract: the host passes cell index arrays in LOGICAL token
order, so the engine under any page-table history presents the
attention reduction with identical operand values in identical order
to the sequential oracle's.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.util.tree import leaves


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


# physical page 0: scratch — write sink for inactive/suppressed rows,
# gather target for dead cells (zeroed inside the attention primitives)
SCRATCH_PAGE = 0


def host_outputs(nxt, ok) -> Tuple[np.ndarray, np.ndarray]:
    """The decode step's one device-to-host read: the [S] next tokens
    and the [S] finite verdicts in a single copy."""
    both = torch.stack((nxt, ok.to(nxt.dtype))).cpu().numpy()
    return both[0], both[1].astype(bool)


class _Staging:
    """Host-to-device transfer of one call's int32 inputs: a pinned host
    buffer (on CUDA) copied with non_blocking, reused only after the
    previous copy out of it has completed (an event). Several engines
    may share one program from their own threads: a lock serializes
    the buffer."""

    def __init__(self, device: torch.device, n: int):
        self.device = device
        cuda = device.type == "cuda"
        self.host = torch.empty(n, dtype=torch.int32, pin_memory=cuda)
        self.view = self.host.numpy()
        self.event = torch.cuda.Event() if cuda else None
        self.pending = False
        self.lock = threading.Lock()

    def put(self, parts) -> torch.Tensor:
        if self.event is None:
            return torch.from_numpy(
                np.concatenate([np.asarray(p, np.int32).ravel()
                                for p in parts]))
        with self.lock:
            if self.pending:
                self.event.synchronize()
            off = 0
            for p in parts:
                a = np.asarray(p, np.int32).ravel()
                self.view[off:off + a.size] = a
                off += a.size
            out = self.host.to(self.device, non_blocking=True)
            self.event.record()
            self.pending = True
        return out


class DecodeProgram:
    """One CausalTransformer's chunk-prefill/decode/page-copy programs
    over a fixed slot batch and a fixed physical page pool on the
    model's device. Holds NO request state — serving/continuous.py's
    DecodeEngine owns slots, the page table, the prefix trie and
    refcounts; this class owns shapes, the pool layout, and the
    host-side window-cell arithmetic the engine and the oracle share."""

    def __init__(self, model, max_slots: int = 8, page_size: int = 16,
                 n_pages: Optional[int] = None):
        if page_size & (page_size - 1):
            raise ValueError(f"page_size must be a power of two "
                             f"(page-aligned pow2 blocks): {page_size}")
        if model.params is None:
            model.init()
        self.model = model
        # the weights' own device, which carries an index: a bare "cuda"
        # means the current device of whichever thread uses it, and the
        # engine's loop and watchdog threads start on device 0
        self.device = model.params["tok_emb"].device
        self.max_slots = int(max_slots)
        self.page_size = int(min(page_size, model.max_ctx))
        # the attention window: every slot attends over at most
        # max_ctx logical positions (sliding once positions wrap)
        self.window = int(model.max_ctx)
        self.pages_per_slot = self.window // self.page_size
        if n_pages is None:
            # equal memory to a contiguous per-slot layout, + scratch
            n_pages = self.max_slots * self.pages_per_slot + 1
        self.n_pages = int(n_pages)
        if self.n_pages < self.pages_per_slot + 1:
            raise ValueError(
                f"n_pages {self.n_pages} cannot hold one slot's "
                f"window ({self.pages_per_slot} pages) + scratch")
        from deeplearning4j_tpu_torch.nn.jit_cache import policy_name

        self.precision_policy = policy_name(
            getattr(model, "compute_dtype", None))
        # host-side dispatch tally per program kind — counts EXECUTIONS
        # rather than builds
        self._dispatches = {"step": 0, "chunk": 0, "copy": 0}
        self._build_lock = threading.Lock()
        s, c = self.max_slots, self.window
        self._step_in = _Staging(self.device, 4 * s + 2 * s * c)
        self._chunk_in = _Staging(self.device, self.page_size + 2 * c)

    # ---------------------------------------------------------- layout
    @property
    def kv_shape(self) -> Tuple[int, ...]:
        m = self.model
        return (m.n_layers, 2, self.n_pages, m.n_heads, self.page_size,
                m.head_dim)

    @property
    def kv_bytes(self) -> int:
        return int(np.prod(self.kv_shape)) * 4

    def init_kv(self):
        """The preallocated physical page pool (zeros; cells are
        zeroed in the attention when dead and overwritten before they
        are readable otherwise)."""
        return torch.zeros(self.kv_shape, dtype=torch.float32,
                           device=self.device)

    def chunk_starts(self, prompt_len: int,
                     from_token: int = 0) -> List[int]:
        """The page-aligned chunk schedule for a prompt: one
        `page_size` chunk dispatch per uncovered page, starting at the
        first token the prefix trie did not cover (`from_token` is
        always page-aligned)."""
        if prompt_len < 1:
            raise ValueError("prompt must carry at least one token")
        if prompt_len > self.window:
            raise ValueError(
                f"prompt length {prompt_len} exceeds the attention "
                f"window {self.window}")
        return list(range(int(from_token), prompt_len, self.page_size))

    def window_cells(self, table: Sequence[Optional[int]],
                     pos: int) -> Tuple[np.ndarray, np.ndarray]:
        """Host-side virtual→physical translation: the per-cell
        (page, offset) arrays for one slot's attention window at
        logical position `pos`, in LOGICAL token order — cell j holds
        position pos+1-live+j, where live = min(pos+1, window). Dead
        cells (j >= live) point at the scratch page. Shared by the
        engine and the sequential oracle — the single definition of
        reduction order the bitwise contract rests on."""
        c, ps, p = self.window, self.page_size, self.pages_per_slot
        cell_page = np.full(c, SCRATCH_PAGE, np.int32)
        cell_off = np.zeros(c, np.int32)
        live = min(pos + 1, c)
        if live > 0:
            qs = np.arange(pos + 1 - live, pos + 1)
            rings = (qs // ps) % p
            # one lookup per ring entry, then a vectorized gather (the
            # window is 1024 cells at GPT-2 width)
            pages = np.full(p, -1, np.int64)
            for r in np.unique(rings):
                if table[r] is None:
                    raise ValueError(f"ring entry {r} of a live position "
                                     f"is unmapped")
                pages[r] = table[r]
            cell_page[:live] = pages[rings]
            cell_off[:live] = qs % ps
        return cell_page, cell_off

    # --------------------------------------------------------- programs
    def decode_key(self):
        return ("decode_step", self.max_slots, self.window,
                self.n_pages)

    def chunk_key(self):
        return ("decode_chunk_prefill", self.page_size, self.window,
                self.n_pages)

    def copy_key(self):
        return ("decode_page_copy", self.n_pages)

    def _program(self, key, builder):
        cache = self.model._jit_cache
        if key not in cache:
            # engines sharing the program build it from their own
            # threads: one closure per key, so one trace per signature
            with self._build_lock:
                if key not in cache:
                    cache[key] = builder(str(key))
                    cache.register_policy(key, self.precision_policy)
        return cache[key]

    def _decode_program(self):
        return self._program(self.decode_key(), self._build_decode)

    def _chunk_program(self):
        return self._program(self.chunk_key(), self._build_chunk)

    def _copy_program(self):
        return self._program(self.copy_key(), self._build_copy)

    def _first_call(self, trace_key: str):
        """A program body's build marker: `mark(signature)` records a
        trace of the key on the first call with each input signature
        (the pool's and index arrays' shapes) — where a JAX program
        retraces, so a call off the key's shapes moves the build count.
        Engines sharing the program may call it from their own threads
        at once."""
        cache = self.model._jit_cache
        seen = set()
        lock = threading.Lock()

        def mark(signature):
            if signature not in seen:
                with lock:
                    if signature not in seen:
                        seen.add(signature)
                        cache.record_trace(trace_key)

        return mark

    def _build_decode(self, trace_key: str):
        """The shared decode step. Per-slot independence is the load-
        bearing property: no op mixes slots (batched products, per-row
        norms/softmax, per-row gathers), so an active slot's emitted
        token is a function of ITS cells alone."""
        from deeplearning4j_tpu_torch.nn.attention import (
            block_decode_finish,
            decode_qkv,
            layer_norm,
            lm_logits,
        )

        model = self.model
        n_heads = model.n_heads
        max_ctx = model.max_ctx
        window = self.window
        mark = self._first_call(trace_key)
        # broadcast head index for the [S, H, C, D] head-major gather
        hidx = torch.arange(n_heads, device=self.device)[None, :, None]

        @torch.no_grad()
        def decode_fn(params, pool, tokens, positions, cell_page,
                      cell_off, write_page, write_off):
            mark((pool.shape, cell_page.shape))
            # logical positions grow unbounded past max_ctx (ring
            # wrap); the learned positional table wraps with them
            x = (params["tok_emb"][tokens]
                 + params["pos_emb"][positions % max_ctx])
            live = torch.clamp(positions + 1, max=window)
            cp = cell_page[:, None, :]        # [S, 1, C] vs hidx
            co = cell_off[:, None, :]
            for li, lp in enumerate(params["layers"]):
                q, k, v = decode_qkv(lp, x, n_heads)
                # scatter: pool[li, io, wp[s], h, wo[s]] = k[s, h] —
                # both write indices are [S] tensors, so the advanced
                # dims lead and the target is [S, H, D] as in NumPy.
                # Suppressed rows all write (SCRATCH_PAGE, 0): their
                # order is unspecified and nothing reads it as live.
                pool[li, 0, write_page, :, write_off] = k
                pool[li, 1, write_page, :, write_off] = v
                # gather: [S, H, C, D] head-major window cells in
                # logical order — the virtual-memory read
                kg = pool[li, 0][cp, hidx, co]
                vg = pool[li, 1][cp, hidx, co]
                x = block_decode_finish(lp, x, q, kg, vg, live)
            xf = layer_norm(x, params["lnf_g"], params["lnf_b"])
            logits = lm_logits(xf, params["tok_emb"])
            # ties break on the first index, as jnp.argmax does
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            # per-slot finite-logits verdict: a False row's token is
            # numeric poison (the engine quarantines the slot)
            ok = torch.all(torch.isfinite(logits), dim=-1)
            return pool, nxt, ok

        return decode_fn

    def _build_chunk(self, trace_key: str):
        """The chunk-prefill program: one page_size slice of a prompt,
        causal within the chunk, prior context via gathered cells, K/V
        parked into ONE physical page. Pad rows beyond the prompt write
        page cells the live masks never expose; decoding overwrites
        them cell by cell."""
        from deeplearning4j_tpu_torch.nn.attention import (
            block_chunk_prefill,
            decode_qkv,
        )

        model = self.model
        n_heads = model.n_heads
        t = self.page_size
        mark = self._first_call(trace_key)
        hidx = torch.arange(n_heads, device=self.device)[:, None]
        offs = torch.arange(t, device=self.device)  # the page's cells

        @torch.no_grad()
        def chunk_fn(params, pool, tokens, start, cell_page, cell_off,
                     write_page):
            mark((pool.shape, tokens.shape, cell_page.shape))
            x = params["tok_emb"][tokens] + params["pos_emb"][start:start + t]
            cp = cell_page[None, :]
            co = cell_off[None, :]
            for li, lp in enumerate(params["layers"]):
                # project + PARK the chunk's K/V before gathering the
                # prior cells (scatter, then gather). The prior cells
                # never alias `write_page`: prefill never wraps, so
                # they point at earlier blocks' pages or scratch.
                q, k, v = decode_qkv(lp, x, n_heads)
                # The JAX program writes pool.at[li, 0, wp, :, offs]
                # with a scalar wp: NumPy and JAX count the scalar as an
                # advanced index, so the target is [T, H, D]. PyTorch
                # takes a Python int (or a 0-d tensor) as a basic index
                # and the same expression targets [H, T, D] — a shape
                # error, or a silently transposed page when page_size ==
                # n_heads. So select the page first and write the
                # head-major [H, T, D] rows explicitly.
                pool[li, 0, write_page][:, offs] = k.transpose(0, 1)
                pool[li, 1, write_page][:, offs] = v.transpose(0, 1)
                kg = pool[li, 0][cp, hidx, co]      # [H, C, D]
                vg = pool[li, 1][cp, hidx, co]
                x = block_chunk_prefill(lp, x, n_heads, kg, vg, start,
                                        qkv=(q, k, v))
            return pool

        return chunk_fn

    def _build_copy(self, trace_key: str):
        """The copy-on-write primitive: duplicate one physical page
        (every layer, K and V) inside the pool."""
        mark = self._first_call(trace_key)

        @torch.no_grad()
        def copy_fn(pool, src, dst):
            mark(pool.shape)
            pool[:, :, dst] = pool[:, :, src]
            return pool

        return copy_fn

    # ----------------------------------------------------------- run
    def step(self, kv, tokens, positions, cell_page, cell_off,
             write_page, write_off):
        """One decode step over all slots. `tokens`/`positions`/
        `write_page`/`write_off` are host [max_slots] int arrays and
        `cell_page`/`cell_off` host [max_slots, window] int arrays
        (the engine's translated page table); returns
        (kv, next_tokens, finite_ok) with `kv` updated in place and
        returned. `next_tokens` ([max_slots] int32) and `finite_ok`
        ([max_slots] bool) stay on the device; read both with
        `host_outputs`. Inactive/suppressed rows write scratch and
        gather scratch-backed dead cells — the host decides whose
        outputs are real."""
        fn = self._decode_program()
        self._dispatches["step"] += 1
        s, c = self.max_slots, self.window
        dev = self._step_in.put((tokens, positions, write_page,
                                 write_off, cell_page, cell_off))
        dev = dev.to(torch.int64)
        tok, pos, wp, wo = (dev[i * s:(i + 1) * s] for i in range(4))
        cp = dev[4 * s:4 * s + s * c].view(s, c)
        co = dev[4 * s + s * c:].view(s, c)
        return fn(self.model.params, kv, tok, pos, cp, co, wp, wo)

    def prefill_chunk(self, kv, chunk: Sequence[int], start: int,
                      cell_page, cell_off, write_page: int):
        """Prefill one page-aligned prompt chunk (positions
        start..start+len(chunk)-1, padded to page_size) into physical
        page `write_page`, attending to the prior context through
        `cell_page`/`cell_off` ([window] arrays, cells >= start dead).
        Updates `kv` in place and returns it."""
        chunk = np.asarray(chunk, np.int32).ravel()
        padded = np.zeros(self.page_size, np.int32)
        padded[:len(chunk)] = chunk
        fn = self._chunk_program()
        self._dispatches["chunk"] += 1
        t, c = self.page_size, self.window
        dev = self._chunk_in.put((padded, cell_page, cell_off))
        dev = dev.to(torch.int64)
        return fn(self.model.params, kv, dev[:t], int(start),
                  dev[t:t + c], dev[t + c:], int(write_page))

    def copy_page(self, kv, src: int, dst: int):
        """Copy-on-write: duplicate physical page `src` into `dst`
        (all layers, K and V). Updates `kv` in place and returns it."""
        fn = self._copy_program()
        self._dispatches["copy"] += 1
        return fn(kv, int(src), int(dst))

    def warmup(self, kv, buckets: Sequence[int] = ()):
        """Build all three programs up front (builds happen before
        traffic, the build counters pin that none happen after).
        `buckets` is accepted for call-site compatibility and ignored —
        chunked prefill has ONE chunk shape. Returns the pool."""
        del buckets
        kv = self.copy_page(kv, SCRATCH_PAGE, SCRATCH_PAGE)
        cp, co = self.window_cells([SCRATCH_PAGE] * self.pages_per_slot,
                                   -1)
        kv = self.prefill_chunk(kv, [0] * self.page_size, 0, cp, co,
                                SCRATCH_PAGE)
        s, c = self.max_slots, self.window
        kv, nxt, ok = self.step(kv, np.zeros(s, np.int32),
                                np.zeros(s, np.int32),
                                np.zeros((s, c), np.int32),
                                np.zeros((s, c), np.int32),
                                np.zeros(s, np.int32),
                                np.zeros(s, np.int32))
        host_outputs(nxt, ok)
        return kv

    def trace_stats(self) -> dict:
        cache = self.model._jit_cache
        return {"trace_counts": cache.trace_counts(),
                "total_traces": cache.total_traces(),
                "compiles_total": cache.compiles_total(),
                "compile_events": cache.compile_events(),
                "dispatches": dict(self._dispatches)}

    # ------------------------------------------------------------ lint
    def lint_records(self, buckets: Sequence[int] = ()) -> List:
        """The JAX package lints the lowered programs (donation,
        transpose churn); the port has no program lint yet."""
        raise NotImplementedError(
            "DecodeProgram.lint_records needs a program lint for the "
            "port, which waits for ROADMAP queue 10c (analysis/*)")

    # ------------------------------------------------------------ perf
    def step_flops(self) -> float:
        """FLOPs of one decode step counted from the shapes (two per
        multiply-add): per layer and slot the q/k/v/o projections, the
        two window contractions over every cell, the MLP; the tied
        head."""
        m = self.model
        s, c, d, f = self.max_slots, self.window, m.d_model, m.d_ff
        per_layer = 2 * s * (4 * d * d + 2 * d * f + 2 * c * d)
        return float(m.n_layers * per_layer + 2 * s * d * m.vocab_size)

    def chunk_flops(self) -> float:
        """FLOPs of one chunk-prefill dispatch from the shapes: per
        layer the projections and MLP of page_size rows and the
        contractions against the window's cells and the chunk."""
        m = self.model
        t, c, d, f = self.page_size, self.window, m.d_model, m.d_ff
        per_layer = 2 * t * (4 * d * d + 2 * d * f + 2 * (c + t) * d)
        return float(m.n_layers * per_layer)

    def step_bytes(self) -> float:
        """Bytes one decode step moves at the least: the weights (the
        tied head included) read once and every window cell of every
        slot read once (K and V, every layer)."""
        m = self.model
        weights = sum(int(t.numel()) for t in leaves(m.params)) * 4
        cells = (self.max_slots * self.window * m.n_layers * 2
                 * m.d_model * 4)
        return float(weights + cells)

    def register_perf(self, cost_model, bucket_len: Optional[int] = None):
        """Register the decode step (and the chunk-prefill program when
        `bucket_len` is given) with `cost_model`, FLOPs counted from
        the shapes (`CostModel.register_counted`); the cost digests
        follow the programs' build events. Returns the decode entry."""
        cache = self.model._jit_cache
        entry = cost_model.register_counted(
            self.decode_key(), self.step_flops(), self.step_bytes(),
            source="decode step: shape count")
        cache.register_cost(self.decode_key(), entry)
        if bucket_len:
            chunk = cost_model.register_counted(
                self.chunk_key(), self.chunk_flops(), None,
                source="chunk prefill: shape count")
            cache.register_cost(self.chunk_key(), chunk)
        return entry
