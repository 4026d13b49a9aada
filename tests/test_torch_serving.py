"""The port's paged-KV serving stack against the JAX package's, on the CPU.

Weights come from the JAX package's ``init_params`` and cross to the port
through numpy (``params_from_numpy``); prompts come from seeded numpy.
The paged functions are held to the JAX ones at f32 rtol 2e-4 / atol
2e-5 (logits and the pages they write), bf16 at the 5e-2 / 5e-3 of
tests/test_ops.py:263-271, greedy tokens exactly.  The host half (block
account, engine, drafts, prefill pool) runs against the reference's under
the same scripts and a manual clock, and must give the same tokens,
events and counters.  The CUDA graphs of ``LlamaRunner`` run only on the
card: tests/test_torch_kernels_gpu.py holds them against eager steps.
"""

import dataclasses
import random
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tensorfusion_tpu.models import llama as jl  # noqa: E402
from tensorfusion_tpu.remoting.dispatch import BusyError as JBusy  # noqa: E402
from tensorfusion_tpu.serving import disagg as jd  # noqa: E402
from tensorfusion_tpu.serving import engine as je  # noqa: E402
from tensorfusion_tpu.serving import kvpool as jk  # noqa: E402
from tensorfusion_tpu.serving import runner as jr  # noqa: E402
from tensorfusion_tpu.serving import spec as js  # noqa: E402
from tensorfusion_tpu_torch.models import convert  # noqa: E402
from tensorfusion_tpu_torch.models import llama as tl  # noqa: E402
from tensorfusion_tpu_torch.remoting.dispatch import BusyError as TBusy  # noqa: E402
from tensorfusion_tpu_torch.serving import disagg as td  # noqa: E402
from tensorfusion_tpu_torch.serving import engine as te  # noqa: E402
from tensorfusion_tpu_torch.serving import kvpool as tk  # noqa: E402
from tensorfusion_tpu_torch.serving import runner as tr  # noqa: E402
from tensorfusion_tpu_torch.serving import spec as ts  # noqa: E402

torch.set_num_threads(1)

F32 = dict(rtol=2e-4, atol=2e-5)
TORCH_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}

#: the two stacks, module by module, for scripts that run on either
REF = SimpleNamespace(engine=je, runner=jr, spec=js, disagg=jd, Busy=JBusy)
PORT = SimpleNamespace(engine=te, runner=tr, spec=ts, disagg=td, Busy=TBusy)


def _configs(**kw):
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), **kw)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(tl.LlamaConfig)}
    fields["dtype"] = TORCH_DTYPES[jcfg.dtype]
    return jcfg, tl.LlamaConfig(**fields)


def _convert(jp):
    return convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                     device="cpu")


@pytest.fixture(scope="module")
def model():
    """(jax config, port config, jax params, port params) at tiny()."""
    jcfg, tcfg = _configs()
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, _convert(jp)


def _prompt(n, seed):
    return [int(t) for t in np.random.default_rng(seed).integers(1, 255, n)]


def _pad(table, m):
    return table + [0] * (m - len(table))


#: the JAX paged functions, compiled once per shape (faster on the CPU
#: than op by op).  bf16 runs op by op: compiled, XLA keeps intermediates
#: of a fusion in f32 where each op would round them to bf16.
_JIT = {name: jax.jit(getattr(jk, name), static_argnames="config")
        for name in ("paged_prefill_chunk", "paged_decode_step",
                     "paged_verify_step")}
_EAGER = {name: getattr(jk, name) for name in _JIT}


class _Pair:
    """One paged pool on each side, written by the same calls."""

    def __init__(self, model, num_blocks, block_size):
        self.jcfg, self.tcfg, self.jp, self.tp = model
        self.fns = _JIT if self.jcfg.dtype == jnp.float32 else _EAGER
        self.jc = jk.init_paged_cache(self.jcfg, num_blocks, block_size)
        self.tc = tk.init_paged_cache(self.tcfg, num_blocks, block_size,
                                      device="cpu")

    def prefill(self, tokens, table, start):
        t = np.asarray(tokens, np.int32)
        tab = np.asarray(table, np.int32)
        want, self.jc = self.fns["paged_prefill_chunk"](
            self.jp, jnp.asarray(t), self.jc, jnp.asarray(tab),
            jnp.int32(start), config=self.jcfg)
        got, cache = tk.paged_prefill_chunk(
            self.tp, torch.from_numpy(t), self.tc, torch.from_numpy(tab),
            start, self.tcfg)
        assert cache is self.tc
        return got.numpy(), np.asarray(want)

    def step(self, fn_name, tokens, tables, pos):
        t, tab, p = (np.asarray(x, np.int32) for x in (tokens, tables, pos))
        want, self.jc = self.fns[fn_name](
            self.jp, jnp.asarray(t), self.jc, jnp.asarray(tab), jnp.asarray(p),
            config=self.jcfg)
        got, cache = getattr(tk, fn_name)(
            self.tp, torch.from_numpy(t), self.tc, torch.from_numpy(tab),
            torch.from_numpy(p), self.tcfg)
        assert cache is self.tc
        return got.numpy(), np.asarray(want)

    def assert_pages_match(self):
        for kind in ("k", "v"):
            for got, want in zip(self.tc[kind], self.jc[kind]):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def _prefill_seq(pair, prompt, table, chunk):
    """Chunked prefill on both sides, logits held at every chunk; returns
    the first greedy token."""
    for lo in range(0, len(prompt), chunk):
        got, want = pair.prefill(prompt[lo:lo + chunk], table, lo)
        np.testing.assert_allclose(got, want, **F32)
    assert int(np.argmax(got)) == int(np.argmax(want))
    return int(np.argmax(got))


def _port_generate(model, prompt, steps):
    _, tcfg, _, tp = model
    return tl.generate(tp, torch.tensor([prompt]), steps, tcfg,
                       device="cpu")[0].tolist()


# -- paged attention against the JAX functions ------------------------------


@pytest.mark.parametrize("block_size", [3, 4, 8])
def test_paged_prefill_and_decode_match_jax(model, block_size):
    """A 7-token prompt prefilled in chunks of 4, then 6 decode steps,
    at block sizes that do and do not divide the lengths: logits and the
    written pages within f32 tolerance, greedy tokens equal to JAX's and
    to the port's contiguous generate."""
    prompt, steps = _prompt(7, 0), 6
    pair = _Pair(model, 32, block_size)
    acct = tk.BlockAccount(32, block_size)
    acct.ensure("s", 7 + steps)
    table = _pad(acct.table("s"), tk.pow2_bucket(len(acct.table("s")), lo=4))
    out = [_prefill_seq(pair, prompt, table, chunk=4)]
    pair.assert_pages_match()
    for i in range(steps - 1):
        got, want = pair.step("paged_decode_step", [out[-1]], [table], [7 + i])
        np.testing.assert_allclose(got, want, **F32)
        assert int(np.argmax(got[0])) == int(np.argmax(want[0]))
        out.append(int(np.argmax(got[0])))
    pair.assert_pages_match()
    assert out == _port_generate(model, prompt, steps)


def test_ragged_fused_decode_matches_jax(model):
    """Sequences at different positions decode in one fused step: each
    row's logits and tokens match JAX's, and its tokens its own
    contiguous run."""
    lens, steps = [3, 6, 9], 5
    prompts = [_prompt(n, 1 + i) for i, n in enumerate(lens)]
    pair = _Pair(model, 48, 4)
    acct = tk.BlockAccount(48, 4)
    tables, out = [], []
    for i, p in enumerate(prompts):
        acct.ensure(i, len(p) + steps)
        tables.append(acct.table(i))
        out.append([_prefill_seq(pair, p, _pad(tables[-1], 8), chunk=4)])
    m = max(len(t) for t in tables)
    tab = [_pad(t, m) for t in tables]
    pos = list(lens)
    for _ in range(steps - 1):
        got, want = pair.step("paged_decode_step", [o[-1] for o in out], tab,
                              pos)
        np.testing.assert_allclose(got, want, **F32)
        for i in range(3):
            out[i].append(int(np.argmax(got[i])))
            assert out[i][-1] == int(np.argmax(want[i]))
            pos[i] += 1
    pair.assert_pages_match()
    for p, o in zip(prompts, out):
        assert o == _port_generate(model, p, steps)


def test_block_reuse_after_retirement_matches_jax(model):
    """Blocks a retired sequence released, handed to a new one, behave
    like fresh ones: the stale pages are overwritten or masked."""
    p1, p2 = _prompt(8, 2), _prompt(5, 3)
    pair = _Pair(model, 9, 4)
    acct = tk.BlockAccount(9, 4)           # 8 usable: p1 takes most of it
    acct.ensure("a", 12)
    ta = _pad(acct.table("a"), 4)
    tok = _prefill_seq(pair, p1, ta, chunk=8)
    for i in range(3):
        got, _ = pair.step("paged_decode_step", [tok], [ta], [8 + i])
        tok = int(np.argmax(got[0]))
    assert acct.release("a") == 3
    acct.ensure("b", 10)
    tb = _pad(acct.table("b"), 4)
    assert set(acct.table("b")) & set(ta[:3]), "expected block reuse"
    out = [_prefill_seq(pair, p2, tb, chunk=4)]
    for i in range(4):
        got, want = pair.step("paged_decode_step", [out[-1]], [tb], [5 + i])
        np.testing.assert_allclose(got, want, **F32)
        out.append(int(np.argmax(got[0])))
    pair.assert_pages_match()
    assert out == _port_generate(model, p2, 5)


def test_verify_with_one_token_equals_decode(model):
    """paged_verify_step at S = 1 is paged_decode_step with an extra
    axis: the same logits and the same pages."""
    jcfg, tcfg, _, tp = model
    prompts = [_prompt(5, 4), _prompt(10, 5)]
    caches = []
    for _ in range(2):
        pair = _Pair(model, 16, 3)
        tables = [[1, 2, 3, 4], [5, 6, 7, 8]]
        toks = [_prefill_seq(pair, p, t, chunk=4)
                for p, t in zip(prompts, tables)]
        caches.append(pair.tc)
    args = dict(block_tables=torch.tensor(tables, dtype=torch.int32),
                pos=torch.tensor([5, 10], dtype=torch.int32), config=tcfg)
    dec, _ = tk.paged_decode_step(tp, torch.tensor(toks, dtype=torch.int32),
                                  caches[0], **args)
    ver, _ = tk.paged_verify_step(tp, torch.tensor([[t] for t in toks],
                                                   dtype=torch.int32),
                                  caches[1], **args)
    assert ver.shape == (2, 1, jcfg.vocab_size)
    np.testing.assert_allclose(ver[:, 0].numpy(), dec.numpy(), **F32)
    assert ver[:, 0].argmax(-1).tolist() == dec.argmax(-1).tolist()
    for kind in ("k", "v"):
        for a, b in zip(caches[0][kind], caches[1][kind]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **F32)


def test_verify_three_tokens_matches_jax(model):
    """S = 3 over ragged rows at block size 3, so the verified positions
    cross block boundaries: logits and pages against JAX's."""
    prompts = [_prompt(5, 6), _prompt(8, 7)]
    pair = _Pair(model, 16, 3)
    tables = [[1, 2, 3, 4], [5, 6, 7, 8]]
    toks = [_prefill_seq(pair, p, t, chunk=4) for p, t in zip(prompts, tables)]
    rows = [[toks[0], 11, 12], [toks[1], 13, 14]]
    got, want = pair.step("paged_verify_step", rows, tables, [5, 8])
    assert got.shape == (2, 3, 256)
    np.testing.assert_allclose(got, want, **F32)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    pair.assert_pages_match()


def test_contiguous_to_paged_from_port_prefill(model):
    """The port's own contiguous prefill cache moved into pool pages
    (in place) equals JAX's move of the same cache, and paged decode
    continues it to the contiguous generate's tokens."""
    jcfg, tcfg, _, tp = model
    prompt, bs = _prompt(10, 8), 4
    logits, cache = tl.prefill(tp, torch.tensor([prompt]), tcfg, cache_len=10)
    paged = tk.init_paged_cache(tcfg, 8, bs, device="cpu")
    before = [t.data_ptr() for t in paged["k"] + paged["v"]]
    table = [3, 1, 6]
    assert tk.contiguous_to_paged(cache, paged, table, 10, bs) is paged
    assert [t.data_ptr() for t in paged["k"] + paged["v"]] == before
    jpaged = jk.contiguous_to_paged(
        {k: [jnp.asarray(t.numpy()) for t in v] for k, v in cache.items()},
        jk.init_paged_cache(jcfg, 8, bs), table, 10, bs)
    for kind in ("k", "v"):
        for got, want in zip(paged[kind], jpaged[kind]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    out = [int(logits[0].argmax())]
    tab = torch.tensor([_pad(table, 4)], dtype=torch.int32)
    for i in range(4):
        lg, _ = tk.paged_decode_step(tp, torch.tensor([out[-1]]), paged, tab,
                                     torch.tensor([10 + i]), tcfg)
        out.append(int(lg[0].argmax()))
    assert out == _port_generate(model, prompt, 5)


def test_bf16_paged_logits_track_jax():
    """bf16 prefill and decode through the pool: the port's logits stay
    within 5e-2 of the largest and 5e-3 on average of JAX's, and no
    further from them than JAX's bf16 logits are from its f32 ones."""
    jcfg, tcfg = _configs(dtype=jnp.bfloat16)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(10))
    model = (jcfg, tcfg, jp, _convert(jp))
    jcfg32 = dataclasses.replace(jcfg, dtype=jnp.float32)
    jp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    pair = _Pair(model, 8, 4)
    prompt = _prompt(9, 11)
    table = [2, 3, 4, 0]
    got, want = pair.prefill(prompt, table, 0)
    want32, _ = jk.paged_prefill_chunk(
        jp32, jnp.asarray(prompt, jnp.int32), jk.init_paged_cache(jcfg32, 8, 4),
        jnp.asarray(table, jnp.int32), jnp.int32(0), config=jcfg32)
    gd, wd = pair.step("paged_decode_step", [7], [table], [9])
    for g, w, w32 in ((got, want, np.asarray(want32)), (gd[0], wd[0], None)):
        err = np.abs(g - w)
        assert err.max() < 5e-2 * np.abs(w).max()
        assert err.mean() < 5e-3
        if w32 is not None:
            assert err.max() <= np.abs(w - w32).max()


def test_init_paged_cache_rejects_kv_quant_and_sizes_like_jax():
    jcfg, tcfg = _configs(kv_quant=True)
    with pytest.raises(ValueError, match="kv_quant"):
        tk.init_paged_cache(tcfg, 8, 4, device="cpu")
    for dtype in (jnp.float32, jnp.bfloat16):
        jcfg, tcfg = _configs(dtype=dtype)
        cache = tk.init_paged_cache(tcfg, 6, 4, device="cpu")
        held = sum(t.nbytes for t in cache["k"] + cache["v"])
        assert held == tk.paged_cache_nbytes(tcfg, 6, 4) \
            == jk.paged_cache_nbytes(jcfg, 6, 4)
        assert all(not t.any() for t in cache["k"] + cache["v"])


# -- the host half against the reference's ---------------------------------


def test_chain_keys_and_buckets_match_reference():
    rng = random.Random(0)
    for _ in range(50):
        toks = [rng.randrange(-5, 300) for _ in range(rng.randrange(0, 40))]
        bs = rng.randrange(1, 9)
        assert tk.prompt_block_keys(toks, bs) == jk.prompt_block_keys(toks, bs)
        parent = rng.randrange(0, 2 ** 63)
        assert tk.chain_key(parent, toks) == jk.chain_key(parent, toks)
        n, lo = rng.randrange(0, 300), rng.randrange(0, 9)
        assert tk.pow2_bucket(n, lo) == jk.pow2_bucket(n, lo)
    assert tk.RESERVED_BLOCKS == jk.RESERVED_BLOCKS and tk.ROOT_KEY == jk.ROOT_KEY


_PROMPTS = [[1, 2, 3, 4, 5, 6, 7, 8, 9], [1, 2, 3, 4, 5, 6, 7, 8, 10],
            [1, 2, 3, 4, 11, 12], [20, 21, 22, 23, 24, 25, 26, 27]]
_KEYS = [jk.prompt_block_keys(p, 4) for p in _PROMPTS]


def _account_ops(seed, n=500):
    """One seeded random script over every mutating call of BlockAccount."""
    rng = random.Random(seed)
    ops = []
    for _ in range(n):
        kind = rng.choice(["ensure", "ensure", "release", "truncate", "adopt",
                           "publish", "writable", "append_block",
                           "adopt_block", "drop_prefix_cache", "peek_match",
                           "can_fit"])
        owner = rng.randrange(6)
        key = rng.choice(rng.choice(_KEYS))[0]
        args = {"ensure": (owner, rng.randrange(0, 30)),
                "release": (owner, rng.random() < 0.3),
                "truncate": (owner, rng.randrange(0, 20)),
                "adopt": (owner, rng.randrange(len(_KEYS))),
                "publish": (owner, rng.randrange(4), key),
                "writable": (owner, rng.randrange(4)),
                "append_block": (owner,),
                "adopt_block": (owner, key),
                "drop_prefix_cache": (),
                "peek_match": (rng.randrange(len(_KEYS)),),
                "can_fit": (rng.randrange(0, 100),)}[kind]
        ops.append((kind, args))
    return ops


def _apply(acct, kind, args):
    if kind in ("adopt", "peek_match"):
        args = args[:-1] + (_KEYS[args[-1]],)
    try:
        return "ok", getattr(acct, kind)(*args)
    except (KeyError, IndexError, RuntimeError) as e:
        return "raise", type(e).__name__


@pytest.mark.parametrize("persistent_prefix", [False, True])
def test_block_account_matches_reference(persistent_prefix):
    """The same seeded script of ensure / release / truncate / adopt /
    publish / writable (and the rest) on both accounts: equal answers,
    snapshots, tables and dirty sets after every call."""
    got = tk.BlockAccount(24, 4, persistent_prefix=persistent_prefix)
    want = jk.BlockAccount(24, 4, persistent_prefix=persistent_prefix)
    kinds = set()
    for kind, args in _account_ops(1 + persistent_prefix):
        res = _apply(got, kind, args)
        assert res == _apply(want, kind, args), (kind, args)
        kinds.add((kind, res[0]))
        assert got.snapshot() == want.snapshot(), (kind, args)
        assert [got.table(o) for o in range(6)] == \
            [want.table(o) for o in range(6)]
        assert got.dirty_since(0) == want.dirty_since(0)
    # the script reached every call, and some failed on both sides
    assert {k for k, _ in kinds} >= {"ensure", "adopt", "publish", "writable",
                                     "truncate", "release"}
    assert ("adopt", "raise") in kinds and got.snapshot()["cow_copies_total"] > 0
    for bad in ((1, 4), (8, 0)):
        for account in (tk.BlockAccount, jk.BlockAccount):
            with pytest.raises(ValueError):
                account(*bad)


def test_drafts_match_reference():
    rng = random.Random(2)
    for _ in range(40):
        ctx = [rng.randrange(0, 6) for _ in range(rng.randrange(1, 30))]
        n, k = rng.randrange(1, 4), rng.randrange(1, 6)
        assert ts.NGramDraft(n=n, max_scan=12).propose(ctx, k) == \
            js.NGramDraft(n=n, max_scan=12).propose(ctx, k)
        acc, seed = rng.choice([0.0, 0.5, 1.0]), rng.randrange(10)
        assert ts.ArithmeticDraft(tr.FakeRunner(), acc, seed).propose(ctx, k) \
            == js.ArithmeticDraft(jr.FakeRunner(), acc, seed).propose(ctx, k)
    streams = {(1, 2): [3, 4, 5, 6]}
    for ctx in ([1, 2], [1, 2, 3], [1, 2, 9], [7]):
        assert ts.ReplayDraft(streams).propose(ctx, 2) == \
            js.ReplayDraft(streams).propose(ctx, 2)
    for kind in ("none", "ngram"):
        assert type(ts.make_draft(kind)).__name__ == \
            type(js.make_draft(kind)).__name__
    for kind in ("arith", "model", "bogus"):
        with pytest.raises(ValueError):
            ts.make_draft(kind)


class ManualClock:
    """The engine's clock, advanced by hand: both stacks see the same
    times, so latencies and shedding agree to the bit."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def now(self):
        return self.t


def _drive(engine, clock, script, M, max_steps=600):
    """Submit ``script`` ({step: [(tenant, prompt, max_new, kwargs)]}) at
    its steps and step until every admitted request is done.  Returns
    the emitted events, the BUSY rejections, the final snapshot and each
    request's tokens by tenant."""
    events, busy, outs = [], [], {}

    def emit(seq, toks, done, info):
        events.append((seq.sid, seq.tenant, list(toks), done,
                       sorted(info.items())))
        if done:
            outs[seq.tenant] = list(seq.tokens)
    expected = 0
    for step in range(max_steps):
        for tenant, prompt, n, kw in script.get(step, ()):
            try:
                engine.submit(prompt, n, tenant=tenant, emit=emit, **kw)
                expected += 1
            except M.Busy as e:
                busy.append((tenant, e.scope, e.depth, e.retry_after_ms))
        engine.step()
        clock.t += 0.005
        if step >= max(script) and len(outs) == expected:
            break
    assert len(outs) == expected, "requests left unfinished"
    return events, busy, engine.snapshot(), outs


_SYS = list(range(1, 17))


def _fake_scenario(name, M, clock):
    """(engine, script, extra state to compare) of one FakeRunner
    scenario, built from the modules of ``M``."""
    R, E = M.runner.FakeRunner, M.engine.ServingEngine
    low, crit = "low", "critical"
    if name == "join_leave_busy":
        eng = E(R(num_blocks=33, block_size=4), clock=clock, max_batch=2,
                max_waiting=3, prefill_chunk_tokens=8)
        script = {0: [(f"a{i}", [5, 7, 11 + i], 6, {}) for i in range(5)],
                  3: [("b0", [1, 2, 3, 4, 5], 4, {}), ("b1", [9], 3, {})],
                  9: [("c0", [5, 7, 11], 10, {"eos_id": 100})]}
    elif name == "deadline_qos":
        eng = E(R(), clock=clock, max_batch=1, prefill_chunk_tokens=8)
        script = {0: [("hog", [1, 2, 3], 12, {"qos": low})],
                  1: [("late", [4, 5], 4, {"deadline_ms": 1.0}),
                      ("bg", [1, 2], 2, {"qos": low}),
                      ("rt", [1, 2], 2, {"qos": crit})]}
    elif name == "preempt":
        eng = E(R(num_blocks=11, block_size=2), clock=clock, max_batch=4,
                prefill_chunk_tokens=16)
        script = {0: [(f"t{i}", [9, 9, 9], 8, {"qos": low if i else crit})
                      for i in range(3)]}
    elif name in ("prefix_cow", "persistent_prefix"):
        eng = E(R(num_blocks=40, block_size=4), clock=clock, max_batch=4,
                prefill_chunk_tokens=8,
                persistent_prefix=name == "persistent_prefix")
        script = {0: [("warm", _SYS + [40, 41], 6, {})],
                  2: [("fan", _SYS + [50], 5, {}), ("same", list(_SYS), 4, {})],
                  30: [("later", _SYS[:8] + [60, 61], 5, {})]}
    elif name in ("spec_arith", "spec_ngram"):
        runner = R(num_blocks=64)
        draft = (M.spec.ArithmeticDraft(runner, accuracy=0.6)
                 if name == "spec_arith" else M.spec.NGramDraft(n=2))
        eng = E(runner, clock=clock, max_batch=4, draft=draft, spec_k=3)
        second = runner._next(runner._next(7, 2), 3)
        script = {0: [(f"t{i}", [3, 1, 4, 1, 5, i], 12, {}) for i in range(3)],
                  2: [("eos", [5, 7, 7], 10, {"eos_id": second})]}
    elif name in ("disagg", "disagg_fallback"):
        small = name == "disagg_fallback"
        pool = M.disagg.PrefillPool(
            [R(num_blocks=5, block_size=2)] if small
            else [R(num_blocks=128), R(num_blocks=128)],
            inline=True, chunk_tokens=8, clock=clock)
        eng = E(R(num_blocks=128), clock=clock, max_batch=8,
                prefill_pool=pool, disagg_min_tokens=6)
        script = {0: [(f"t{i}", _SYS + [40 + i], 6, {}) for i in range(4)]
                  + [("short", [1, 2, 3], 4, {}),
                     ("big", list(range(1, 30)), 4, {})]}
        return eng, script, lambda: pool.snapshot()
    else:
        raise ValueError(name)
    return eng, script, lambda: vars(eng.runner)


@pytest.mark.parametrize("name", [
    "join_leave_busy", "deadline_qos", "preempt", "prefix_cow",
    "persistent_prefix", "spec_arith", "spec_ngram", "disagg",
    "disagg_fallback"])
def test_engine_with_fake_runner_matches_reference(name):
    """The port's ServingEngine + FakeRunner against the reference's under
    the same submission script and a manual clock: the same events (BUSY
    and deadline shedding included), counters and snapshot."""
    results = []
    for M in (REF, PORT):
        clock = ManualClock()
        eng, script, extra = _fake_scenario(name, M, clock)
        results.append((*_drive(eng, clock, script, M), extra()))
    assert results[1] == results[0]
    events, busy, snap, outs, pool = results[1]
    kv = snap["kv"]
    assert outs and kv["owners"] == 0
    assert kv["used"] == kv["cache_held_blocks"]     # 0 unless persistent
    expect = {"join_leave_busy": lambda: busy and snap["busy_rejected"] == 2,
              "deadline_qos": lambda: snap["shed"] == 1,
              "preempt": lambda: snap["preempted"] > 0,
              "prefix_cow": lambda: kv["cow_copies_total"] > 0,
              "persistent_prefix": lambda: kv["cache_held_blocks"] > 0,
              "spec_arith": lambda: snap["spec"]["steps"] > 0,
              "spec_ngram": lambda: snap["spec"]["proposed"] > 0,
              "disagg": lambda: snap["kv_ship"]["dedup_blocks"] > 0,
              "disagg_fallback": lambda: pool["failed_jobs"] > 0}
    assert expect[name](), snap
    if name == "deadline_qos":
        # the critical tenant was admitted before the earlier low one
        order = [e[1] for e in events if e[2]]
        assert order.index("rt") < order.index("bg")


def _llama_scenario(name, M, model, clock):
    """(engine, script) of one LlamaRunner scenario on either stack."""
    jcfg, tcfg, jp, tp = model
    if M is REF:
        def runner(**kw):
            return jr.LlamaRunner(jp, jcfg, **kw)
    else:
        def runner(**kw):
            return tr.LlamaRunner(tp, tcfg, device="cpu", **kw)
    E = M.engine.ServingEngine
    sysp = [3, 1, 4, 1, 5, 9, 2, 6]
    if name == "join_leave_prefix_preempt":
        # 12 usable blocks of 4: admitted together, the three sequences
        # outgrow the pool (5 + 3 shared-prefix + 5 blocks)
        eng = E(runner(num_blocks=13, block_size=4), clock=clock,
                max_batch=3, prefill_chunk_tokens=4)
        script = {0: [("a", sysp + [8, 1], 10, {"qos": "critical"})],
                  1: [("b", sysp + [7, 2], 10, {"qos": "low"}),
                      ("c", _prompt(4, 20), 16, {"qos": "low"})],
                  3: [("d", _prompt(5, 21), 4, {})]}
    elif name == "ngram_spec":
        eng = E(runner(num_blocks=64, block_size=4), clock=clock, max_batch=2,
                draft=M.spec.NGramDraft(n=2), spec_k=3)
        script = {0: [("a", [3, 1, 4, 1, 5, 9], 10, {})],
                  1: [("b", [2, 7, 1, 8, 2, 7], 10, {})]}
    elif name == "prefill_pool":
        pool = M.disagg.PrefillPool([runner(num_blocks=64, block_size=4)],
                                    inline=True, chunk_tokens=4, clock=clock)
        eng = E(runner(num_blocks=64, block_size=4), clock=clock, max_batch=4,
                prefill_pool=pool)
        script = {0: [("a", sysp + [8, 1], 6, {})],
                  2: [("b", sysp + [7, 2], 5, {}), ("c", [5, 6, 7], 4, {})]}
    else:
        raise ValueError(name)
    return eng, script


@pytest.mark.parametrize("name", ["join_leave_prefix_preempt", "ngram_spec",
                                  "prefill_pool"])
def test_engine_with_llama_runner_matches_jax(model, name):
    """The port's ServingEngine + LlamaRunner(device="cpu") against the
    JAX ServingEngine + LlamaRunner: every request's tokens equal, and so
    every event and counter; the tokens are the contiguous generate's."""
    results = []
    for M in (REF, PORT):
        clock = ManualClock()
        eng, script = _llama_scenario(name, M, model, clock)
        results.append(_drive(eng, clock, script, M))
    assert results[1][3] == results[0][3]
    assert results[1][:3] == results[0][:3]
    snap, outs = results[1][2], results[1][3]
    assert snap["kv"]["used"] == 0
    expect = {"join_leave_prefix_preempt": lambda: snap["preempted"] > 0
              and snap["kv"]["prefix_hits_total"] > 0,
              "ngram_spec": lambda: snap["spec"]["accepted"] > 0,
              "prefill_pool": lambda: snap["kv_ship"]["dedup_blocks"] > 0}
    assert expect[name](), snap
    _, script = _llama_scenario(name, PORT, model, ManualClock())
    for reqs in script.values():
        for tenant, prompt, n, _ in reqs:
            assert outs[tenant] == _port_generate(model, prompt, n), tenant


def test_llama_draft_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    got, want = ts.LlamaDraft(tp, tcfg, window=8), js.LlamaDraft(jp, jcfg, window=8)
    for n in (5, 8, 12):
        ctx = _prompt(n, 30 + n)
        assert got.propose(ctx, 3) == want.propose(ctx, 3)
    assert got.propose(_prompt(12, 42), 3)


def test_runner_pages_move_in_place(model):
    """copy_blocks and write_blocks write the pool in place (a captured
    graph holds its storage), and read_blocks gives what was written."""
    _, tcfg, _, tp = model
    runner = tr.LlamaRunner(tp, tcfg, num_blocks=8, block_size=4, device="cpu")
    assert runner.nbytes == tk.paged_cache_nbytes(tcfg, 8, 4)
    ptrs = [t.data_ptr() for t in runner.cache["k"] + runner.cache["v"]]
    first = runner.prefill(_prompt(6, 50), [1, 2], 0)
    assert first == _port_generate(model, _prompt(6, 50), 1)[0]
    runner.copy_blocks([(1, 3), (2, 4)])
    k, v = runner.read_blocks([3, 4])
    want_k, want_v = runner.read_blocks([1, 2])
    assert k.shape == (tcfg.n_layers, 2, tcfg.n_kv_heads, 4, tcfg.head_dim)
    assert torch.equal(k, want_k) and torch.equal(v, want_v) and k.any()
    runner.write_blocks([5, 6], k.numpy(), v)
    assert torch.equal(runner.read_blocks([5, 6])[0], k)
    assert [t.data_ptr() for t in runner.cache["k"] + runner.cache["v"]] == ptrs
    # the copied pages decode like the originals
    tok = _port_generate(model, _prompt(6, 50), 2)
    assert runner.decode([first, first], [6, 6], [[1, 2], [5, 6]]) == [tok[1]] * 2


def test_llama_runner_needs_a_device_or_a_card(model, monkeypatch):
    _, tcfg, _, tp = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tr.LlamaRunner(tp, tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tk.init_paged_cache(tcfg, 4, 4)
    runner = tr.LlamaRunner(tp, tcfg, num_blocks=4, block_size=4, device="cpu")
    runner.warmup(2, 8, 4)             # captures nothing on the CPU
    assert runner.graphs == {}


def test_capture_gate_holds_eager_calls_off_a_capture():
    """A capture waits for the eager runner calls in flight and holds new
    ones off until it is done; eager calls do not hold each other off."""
    import threading
    import time

    from tensorfusion_tpu_torch.device import _CaptureGate

    gate = _CaptureGate()
    events = []
    inside = threading.Event()
    release = threading.Event()

    def eager(tag, hold=None):
        with gate.shared():
            events.append(f"{tag}+")
            if hold is not None:
                inside.set()
                hold.wait(10)
            events.append(f"{tag}-")

    def capture():
        with gate.exclusive():
            events.append("capture+")
            time.sleep(0.05)
            events.append("capture-")

    first = threading.Thread(target=eager, args=("a", release))
    first.start()
    assert inside.wait(10)
    eager("b")                                   # shared holders coexist
    cap = threading.Thread(target=capture)
    cap.start()
    time.sleep(0.05)
    assert "capture+" not in events              # waits for "a" to leave
    late = threading.Thread(target=eager, args=("c",))
    late.start()
    time.sleep(0.05)
    assert "c+" not in events                    # held off by the capture
    release.set()
    for t in (first, cap, late):
        t.join(10)
    assert events.index("a-") < events.index("capture+") < \
        events.index("capture-") < events.index("c+")
