"""The port's decode path against the JAX package on the same weights and
inputs (deeplearning4j_tpu_torch/nn/attention.py, engine/decode_program.py,
serving/continuous.py, serving/journal.py against deeplearning4j_tpu's).

  * the weight bridge: `CausalTransformer.load_jax_params` carries JAX's
    `init()` tree into the port's tensors bit for bit;
  * every attention primitive, the chunk program's pool and the decode
    program's logits match JAX within TOL (f32; seeded numpy inputs);
  * with page_size == n_heads the chunk scatter writes the page JAX
    writes (a naive translation of `pool.at[li, 0, page, :, offs]`
    transposes it silently);
  * the greedy tokens of the two engines are equal on every request
    whose JAX top-1 margin exceeds 100 x TOL at every step, and there
    are at least four such requests;
  * a journal written by either package recovers in the other.

The programs' logits are read by wrapping each package's `lm_logits`
while the programs are built (JAX's through `jax.debug.callback`).
"""

import random
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.engine.decode_program import (
    DecodeProgram as JDecodeProgram,
)
from deeplearning4j_tpu.nn import attention as ja
from deeplearning4j_tpu.serving.continuous import (
    DecodeEngine as JDecodeEngine,
    sequential_decode as jsequential,
)
from deeplearning4j_tpu.serving.journal import (
    GenerationJournal as JGenerationJournal,
    frame_record as jframe,
    read_records as jread,
)
from deeplearning4j_tpu.zoo.decoder import (
    CausalTransformer as JCausalTransformer,
)
from deeplearning4j_tpu_torch.engine.decode_program import (
    SCRATCH_PAGE,
    DecodeProgram,
    host_outputs,
)
from deeplearning4j_tpu_torch.nn import attention as ta
from deeplearning4j_tpu_torch.serving import continuous as tcont
from deeplearning4j_tpu_torch.serving import journal as tjournal
from deeplearning4j_tpu_torch.serving.continuous import (
    DecodeEngine,
    sequential_decode,
)
from deeplearning4j_tpu_torch.serving.journal import (
    GenerationJournal,
    frame_record,
    read_records,
)
from deeplearning4j_tpu_torch.util.tree import leaves
from deeplearning4j_tpu_torch.zoo.decoder import CausalTransformer

pytestmark = pytest.mark.serving

VOCAB, CTX, SLOTS, PAGE = 64, 64, 4, 8
# f32: the largest |port - JAX| allowed on any compared value (measured
# on these shapes: 1.8e-7 for the attention outputs, 7.5e-8 for the
# decode logits, 8.9e-8 for the pool)
TOL = 1e-5
MARGIN = 100 * TOL


@pytest.fixture(autouse=True)
def _isolation():
    yield
    tcont.reap_stray_engines()
    tjournal.reap_stray_journals()


def _build_pair(n_heads=4, page=PAGE, seed=3):
    """A JAX model and its port twin (bridged weights) with their
    programs built while both packages' `lm_logits` record the
    logits."""
    caps = {"jax": [], "torch": []}
    orig_j, orig_t = ja.lm_logits, ta.lm_logits

    def lm_j(x, e):
        out = orig_j(x, e)
        jax.debug.callback(lambda v: caps["jax"].append(np.asarray(v)),
                           out)
        return out

    def lm_t(x, e):
        out = orig_t(x, e)
        caps["torch"].append(out.detach().cpu().numpy().copy())
        return out

    ja.lm_logits, ta.lm_logits = lm_j, lm_t
    try:
        jm = JCausalTransformer(vocab_size=VOCAB, d_model=32,
                                n_heads=n_heads, n_layers=2, max_ctx=CTX,
                                seed=seed).init()
        tm = CausalTransformer(vocab_size=VOCAB, d_model=32,
                               n_heads=n_heads, n_layers=2, max_ctx=CTX,
                               seed=seed, device="cpu"
                               ).load_jax_params(jm.params)
        pj = JDecodeProgram(jm, max_slots=SLOTS, page_size=page)
        pt = DecodeProgram(tm, max_slots=SLOTS, page_size=page)
        pj.warmup(pj.init_kv())
        pt.warmup(pt.init_kv())
    finally:
        ja.lm_logits, ta.lm_logits = orig_j, orig_t
    caps["jax"].clear()
    caps["torch"].clear()
    return SimpleNamespace(jm=jm, tm=tm, pj=pj, pt=pt, caps=caps)


@pytest.fixture(scope="module")
def pair():
    return _build_pair()


def _requests(n, seed, max_prompt=20, max_new=12):
    rng = random.Random(seed)
    return [([rng.randrange(VOCAB)
              for _ in range(rng.randrange(2, max_prompt))],
             rng.randrange(4, max_new)) for _ in range(n)]


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _jax_margins(pair, prompt, mx):
    """JAX's oracle tokens and its top-1 margin at every step."""
    pair.caps["jax"].clear()
    _, toks = jsequential(pair.pj, prompt, mx)
    margins = []
    for lg in pair.caps["jax"]:
        top = np.sort(lg[0])[::-1]
        margins.append(float(top[0] - top[1]))
    assert len(margins) == len(toks)
    return toks, margins


def _churn(make_engine, reqs, ids=None):
    eng = make_engine()
    handles, i, steps = [], 0, 0
    while i < len(reqs) or any(not h.done for h in handles):
        if i < len(reqs) and steps % 2 == 0:
            p, mx = reqs[i]
            kw = {"request_id": ids[i]} if ids else {}
            handles.append(eng.submit(p, mx, **kw))
            i += 1
        eng.step_once()
        steps += 1
        assert steps < 4000
    return [h.result(timeout_s=0) for h in handles]


# ========================================================== the bridge
def test_bridge_carries_jax_init_bit_for_bit(pair):
    jl = jax.tree_util.tree_leaves(pair.jm.params)
    tl = leaves(pair.tm.params)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert b.dtype == torch.float32 and b.device.type == "cpu"
        assert np.array_equal(np.asarray(a), b.numpy())
    assert isinstance(pair.tm.params["layers"], tuple)
    assert pair.tm.num_params() == pair.jm.num_params()
    assert pair.tm.config() == pair.jm.config()
    wrong = CausalTransformer(vocab_size=VOCAB, d_model=32, n_heads=4,
                              n_layers=3, max_ctx=CTX, device="cpu")
    with pytest.raises(ValueError):
        wrong.load_jax_params(pair.jm.params)


# ================================================== attention primitives
def _inputs(rng):
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    s, h, c, d, t = SLOTS, 4, CTX, 8, PAGE
    kc, vc = f(s, h, c, d), f(s, h, c, d)
    live = np.array([1, 5, c, 30], np.int32)
    # dead cells hold garbage, NaN included: zeroed before contraction
    kc[0, :, 3] = np.nan
    vc[1, :, 9] = np.inf
    kc2, vc2 = f(h, c, d), f(h, c, d)
    kc2[:, 20] = np.nan
    return {"x": f(s, 32), "xt": f(t, 32), "q": f(s, h, d), "kc": kc,
            "vc": vc, "live": live, "qq": f(t, h, d), "kk": f(t, h, d),
            "vv": f(t, h, d), "kc2": kc2, "vc2": vc2, "n_prior": 16,
            "scores": f(s, h, c), "att": f(s, h, d)}


def _call(mod, name, v, lp, emb, to):
    live = to(v["live"])
    if mod is ta:
        live = live.long()
    calls = {
        "layer_norm": lambda: mod.layer_norm(to(v["x"]), lp["ln1_g"] + 0.5,
                                             lp["ln1_b"] + 0.1),
        "qkv_heads": lambda: mod.qkv_heads(lp, to(v["x"]), 4),
        "paged_decode_attention": lambda: mod.paged_decode_attention(
            to(v["q"]), to(v["kc"]), to(v["vc"]), live),
        "chunk_prefill_attention": lambda: mod.chunk_prefill_attention(
            to(v["qq"]), to(v["kk"]), to(v["vv"]), to(v["kc2"]),
            to(v["vc2"]), v["n_prior"]),
        "_softmax": lambda: mod._softmax(to(v["scores"])),
        "mlp_block": lambda: mod.mlp_block(lp, to(v["x"])),
        "block_chunk_prefill": lambda: mod.block_chunk_prefill(
            lp, to(v["xt"]), 4, to(v["kc2"]), to(v["vc2"]), v["n_prior"]),
        "decode_qkv": lambda: mod.decode_qkv(lp, to(v["x"]), 4),
        "block_decode_finish": lambda: mod.block_decode_finish(
            lp, to(v["x"]), to(v["q"]), to(v["kc"]), to(v["vc"]), live),
        "_merge_heads": lambda: mod._merge_heads(to(v["att"])),
        "lm_logits": lambda: mod.lm_logits(to(v["x"]), emb),
    }
    out = calls[name]()
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", [
    "layer_norm", "qkv_heads", "paged_decode_attention",
    "chunk_prefill_attention", "_softmax", "mlp_block",
    "block_chunk_prefill", "decode_qkv", "block_decode_finish",
    "_merge_heads", "lm_logits"])
def test_attention_primitive_matches_jax(pair, name):
    v = _inputs(np.random.default_rng(7))
    got = _call(ta, name, v, pair.tm.params["layers"][0],
                pair.tm.params["tok_emb"], torch.from_numpy)
    want = _call(ja, name, v, pair.jm.params["layers"][0],
                 pair.jm.params["tok_emb"], jnp.asarray)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert np.isfinite(w).all() and torch.isfinite(g).all()
        assert _err(g.numpy(), w) <= TOL, name


# ============================================================= programs
def _prefill_both(pair, prompt, pages, kvj, kvt):
    pj, pt = pair.pj, pair.pt
    table = [None] * pt.pages_per_slot
    for b, start in enumerate(pt.chunk_starts(len(prompt))):
        table[b] = pages[b]
        cp, co = pt.window_cells(table, start - 1)
        chunk = prompt[start:start + PAGE]
        kvj = pj.prefill_chunk(kvj, chunk, start, cp, co, pages[b])
        kvt = pt.prefill_chunk(kvt, chunk, start, cp, co, pages[b])
    return kvj, kvt, table


def test_chunk_program_pool_matches_jax(pair):
    kvj, kvt = pair.pj.init_kv(), pair.pt.init_kv()
    prompt = [5, 9, 11, 2, 7, 1, 3, 3, 8, 9, 10, 11, 12]
    kvj, kvt, _ = _prefill_both(pair, prompt, [3, 6], kvj, kvt)
    assert float(kvt[:, :, 6].abs().sum()) > 0
    assert _err(kvt.numpy(), kvj) <= TOL


def test_decode_program_logits_match_jax(pair):
    """Two slots mid-prompt plus two idle rows: one decode step through
    each package's program — logits, tokens and pools."""
    pj, pt, caps = pair.pj, pair.pt, pair.caps
    kvj, kvt = pj.init_kv(), pt.init_kv()
    s, c = SLOTS, CTX
    prompts = {0: [4, 8, 15, 16, 23, 42, 1, 2, 3, 5],
               2: [7, 7, 1, 9, 30, 2, 6, 6, 1, 1, 2, 3, 5, 8, 13, 21, 34]}
    pages = {0: [1, 2], 2: [5, 9, 11]}
    tokens = np.zeros(s, np.int32)
    positions = np.zeros(s, np.int32)
    cp = np.full((s, c), SCRATCH_PAGE, np.int32)
    co = np.zeros((s, c), np.int32)
    wp = np.full(s, SCRATCH_PAGE, np.int32)
    wo = np.zeros(s, np.int32)
    for slot, prompt in prompts.items():
        kvj, kvt, table = _prefill_both(pair, prompt[:-1], pages[slot],
                                        kvj, kvt)
        pos = len(prompt) - 1
        table[pos // PAGE] = pages[slot][pos // PAGE]
        tokens[slot], positions[slot] = prompt[-1], pos
        cp[slot], co[slot] = pt.window_cells(table, pos)
        wp[slot], wo[slot] = table[pos // PAGE], pos % PAGE
    caps["jax"].clear()
    caps["torch"].clear()
    kvj, nj, okj = pj.step(kvj, tokens, positions, cp, co, wp, wo)
    nj = np.asarray(nj)
    kvt, nt, okt = pt.step(kvt, tokens, positions, cp, co, wp, wo)
    nt, okt = host_outputs(nt, okt)
    (lj,), (lt,) = caps["jax"], caps["torch"]
    assert lt.shape == (s, VOCAB)
    for slot in prompts:
        assert _err(lt[slot], lj[slot]) <= TOL
        top = np.sort(lj[slot])[::-1]
        if top[0] - top[1] > MARGIN:
            assert nt[slot] == nj[slot]
    assert okt[list(prompts)].all() and np.asarray(okj)[list(prompts)].all()
    # pages the two slots own (scratch excepted: its bytes are racy)
    owned = sorted(p for ps in pages.values() for p in ps)
    assert _err(kvt[:, :, owned].numpy(), np.asarray(kvj)[:, :, owned]) \
        <= TOL


def test_chunk_scatter_with_page_size_equal_to_heads():
    """page_size == n_heads: the shape of the naive PyTorch translation
    of JAX's `pool.at[li, 0, page, :, offs].set(k)` matches, and it
    would write the page transposed without an error. The pool after
    one chunk equals JAX's."""
    p8 = _build_pair(n_heads=8, page=8, seed=5)
    assert p8.pt.page_size == p8.tm.n_heads == 8
    kvj, kvt = p8.pj.init_kv(), p8.pt.init_kv()
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    cp, co = p8.pt.window_cells([None] * p8.pt.pages_per_slot, -1)
    kvj = p8.pj.prefill_chunk(kvj, prompt, 0, cp, co, 4)
    kvt = p8.pt.prefill_chunk(kvt, prompt, 0, cp, co, 4)
    assert _err(kvt.numpy(), kvj) <= TOL
    # the page is head-major: [layer, k/v, page, head, offset, dim]
    page = kvt[0, 0, 4]
    assert not torch.allclose(page, page.transpose(0, 1))


def test_greedy_tokens_equal_on_wide_margin_requests(pair):
    reqs = _requests(10, seed=17)
    jaxo = [_jax_margins(pair, p, mx) for p, mx in reqs]
    got_j = _churn(lambda: JDecodeEngine(program=pair.pj, queue_limit=64,
                                         max_prefills_per_step=2), reqs)
    got_t = _churn(lambda: DecodeEngine(program=pair.pt, queue_limit=64,
                                        max_prefills_per_step=2), reqs)
    assert got_j == [t for t, _ in jaxo]      # JAX engine == JAX oracle
    # the port's engine equals the port's oracle bit for bit
    assert got_t == [sequential_decode(pair.pt, p, mx)[1]
                     for p, mx in reqs]
    wide = [i for i, (_, m) in enumerate(jaxo) if min(m) > MARGIN]
    assert len(wide) >= 4, [min(m) for _, m in jaxo]
    for i in wide:
        assert got_t[i] == got_j[i], i


# ============================================================== journal
RECORDS = [
    {"kind": "admitted", "id": "a", "prompt": [1, 2, 3],
     "max_new_tokens": 8, "eos_id": 5, "tenant": "t0", "trace": "ab12"},
    {"kind": "progress", "id": "a", "start": 0, "tokens": [7, 9]},
    {"kind": "done", "id": "a", "finish_reason": "eos"},
    {"kind": "admitted", "id": "b", "prompt": [4], "max_new_tokens": 2,
     "deadline_s": 1.5},
]


def test_journal_framing_is_byte_identical():
    for rec in RECORDS:
        assert frame_record(rec) == jframe(rec)


def test_journal_files_cross_read(tmp_path):
    blob = b"".join(jframe(r) for r in RECORDS)
    path = tmp_path / "seg-00000000.wal"
    path.write_bytes(blob + b"\x03torn")
    assert read_records(str(path)) == jread(str(path))
    recs, valid, total = read_records(str(path))
    assert recs == RECORDS and valid == len(blob) and total > valid


def _recovery_case(pair, seed):
    reqs = [(p, 10) for p, _ in _requests(4, seed=seed, max_prompt=12)]
    jaxo = [_jax_margins(pair, p, mx) for p, mx in reqs]
    ids = [f"x-{seed}-{i}" for i in range(len(reqs))]
    return reqs, jaxo, ids


def _partial(eng, reqs, ids):
    for i, (p, mx) in enumerate(reqs):
        eng.submit(p, mx, request_id=ids[i])
    for _ in range(5):
        eng.step_once()
    eng.stop()


def _finish(eng, reqs, ids):
    handles = [eng.submit(p, mx, request_id=ids[i])
               for i, (p, mx) in enumerate(reqs)]
    steps = 0
    while any(not h.done for h in handles):
        eng.step_once()
        steps += 1
        assert steps < 2000
    return [h.result(timeout_s=0) for h in handles]


def _check_recovered(reqs, jaxo, recorded, got):
    assert any(recorded.values()), "drill never got airborne"
    wide = 0
    for i, (p, mx) in enumerate(reqs):
        rec = recorded[i]
        assert got[i][:len(rec)] == rec and len(got[i]) == mx
        if min(jaxo[i][1]) > MARGIN:
            wide += 1
            assert got[i] == jaxo[i][0]
    assert wide >= 1


def test_jax_journal_recovers_in_the_port(pair, tmp_path):
    reqs, jaxo, ids = _recovery_case(pair, seed=23)
    d = str(tmp_path / "wal")
    j1 = JGenerationJournal(d, fsync_interval_s=0)
    _partial(JDecodeEngine(program=pair.pj, journal=j1), reqs, ids)
    live_j = j1.live()
    j1.close()
    j2 = GenerationJournal(d, fsync_interval_s=0)
    assert j2.live() == live_j and set(live_j) == set(ids)
    eng = DecodeEngine(program=pair.pt, journal=j2)
    assert eng.stats()["journal"]["recovered"] == len(reqs)
    recorded = {i: live_j[ids[i]]["tokens"] for i in range(len(reqs))}
    _check_recovered(reqs, jaxo, recorded, _finish(eng, reqs, ids))
    assert j2.live() == {}
    j2.close()


def test_port_journal_recovers_in_jax(pair, tmp_path):
    reqs, jaxo, ids = _recovery_case(pair, seed=29)
    d = str(tmp_path / "wal")
    j1 = GenerationJournal(d, fsync_interval_s=0)
    _partial(DecodeEngine(program=pair.pt, journal=j1), reqs, ids)
    live_t = j1.live()
    j1.close()
    j2 = JGenerationJournal(d, fsync_interval_s=0)
    assert j2.live() == live_t and set(live_t) == set(ids)
    eng = JDecodeEngine(program=pair.pj, journal=j2)
    assert eng.stats()["journal"]["recovered"] == len(reqs)
    recorded = {i: live_t[ids[i]]["tokens"] for i in range(len(reqs))}
    _check_recovered(reqs, jaxo, recorded, _finish(eng, reqs, ids))
    assert j2.live() == {}
    j2.close()
