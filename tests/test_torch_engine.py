"""The port's serving engine (``repro_torch.serving.engine.Engine``) against
the JAX package's, and the reference's serving regressions on the port.

Cross-package: a narrow float32 deepseek-7b (the config of
``tests/test_serving_scheduler.py``) is initialised by the JAX package from
``PRNGKey(0)`` and carried to the port with
:func:`repro_torch.interop.params_from_numpy`.  Both engines take the same
requests, and after every ``admit`` and ``tick`` their return values, every
request's tokens and ``done`` flag, and the per-slot positions must be
equal: batched admit, mid-decode admit, mixed-length admit, the ``max_len``
ceiling and ``max_new=1``.  Exact: the float32 logits agree to about 5e-6
(``tests/test_torch_models.py``), far inside the gaps between greedy
choices here.

Within the port: the six serving regressions of ``tests/test_substrate.py``
on the port's reduced bf16 model from its own initialisation, exact as in
the reference.  Everything runs on the CPU (``device="cpu"``).
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import ARCHS, reduced
from repro_torch.models.api import build_model
from repro_torch.serving.engine import Engine, Request


def narrow(cfg):
    """The float32 serving-test config of ``tests/test_serving_scheduler.py``."""
    return dataclasses.replace(cfg, dtype="float32", d_model=64, n_heads=2, n_kv_heads=2,
                               head_dim=16, d_ff=128, vocab_size=128)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the serving models here are tiny, and on a host
    shared with other test workers torch's thread pool spends more time
    contending than computing (the 200-example property took 152 s under
    load with 8 threads, 17 s with one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """The reference engine and one float32 init, carried to the port's model."""
    jax = pytest.importorskip("jax")
    from repro.configs import ARCHS as J_ARCHS
    from repro.configs import reduced as j_reduced
    from repro.models.api import build_model as j_build
    from repro.serving import engine as j_engine

    jm = j_build(narrow(j_reduced(J_ARCHS["deepseek-7b"])))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(narrow(reduced(ARCHS["deepseek-7b"])), "cpu")
    tm.set_params(interop.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"))
    return SimpleNamespace(jm=jm, jp=jp, tm=tm, Engine=j_engine.Engine, Request=j_engine.Request)


class Twin:
    """One reference engine and one port engine driven in lock step; every
    call holds the two to each other."""

    def __init__(self, ref, *, slots: int, max_len: int) -> None:
        self.ref = ref
        self.j = ref.Engine(ref.jm, ref.jp, batch_slots=slots, max_len=max_len)
        self.t = Engine(ref.tm, batch_slots=slots, max_len=max_len)
        self.reqs: list[tuple] = []

    def admit(self, specs: list[tuple[int, np.ndarray, int]]) -> int:
        jr = [self.ref.Request(rid, p.copy(), max_new=m) for rid, p, m in specs]
        tr = [Request(rid, p.copy(), max_new=m) for rid, p, m in specs]
        n = self.t.admit(tr)
        assert n == self.j.admit(jr)
        self.reqs += list(zip(jr[:n], tr[:n]))
        self.check()
        return n

    def tick(self) -> bool:
        more = self.t.tick()
        assert more == self.j.tick()
        self.check()
        return more

    def drain(self) -> int:
        ticks = 0
        while self.tick():
            ticks += 1
            assert ticks < 256
        return ticks

    def check(self) -> None:
        np.testing.assert_array_equal(self.t.slot_pos, self.j.slot_pos)
        assert self.t.slot_pos.dtype == np.int32
        assert ([r and r.rid for r in self.t.slot_req] == [r and r.rid for r in self.j.slot_req])
        for jr, tr in self.reqs:
            assert tr.out == jr.out, (tr.rid, tr.out, jr.out)
            assert tr.done == jr.done, tr.rid


def _prompt(rng, n: int) -> np.ndarray:
    return rng.integers(0, 128, n).astype(np.int32)


def test_batched_admit_matches_reference(ref):
    rng = np.random.default_rng(0)
    tw = Twin(ref, slots=3, max_len=64)
    assert tw.admit([(i, _prompt(rng, 8), 5) for i in range(3)]) == 3
    tw.drain()
    assert all(len(t.out) == 5 and t.done for _, t in tw.reqs)


def test_mid_decode_admit_matches_reference(ref):
    rng = np.random.default_rng(1)
    tw = Twin(ref, slots=2, max_len=64)
    assert tw.admit([(0, _prompt(rng, 8), 6)]) == 1
    tw.tick()
    tw.tick()
    assert tw.admit([(1, _prompt(rng, 6), 4), (2, _prompt(rng, 5), 3)]) == 1   # one free slot
    tw.drain()
    assert tw.admit([(2, _prompt(rng, 5), 3)]) == 1      # done slots released wholesale
    tw.drain()
    assert [len(t.out) for _, t in tw.reqs] == [6, 4, 3]


def test_mixed_length_admit_matches_reference(ref):
    rng = np.random.default_rng(4)
    tw = Twin(ref, slots=3, max_len=64)
    assert tw.admit([(0, _prompt(rng, 8), 6), (1, _prompt(rng, 5), 6),
                     (2, _prompt(rng, 8), 4)]) == 3
    tw.drain()


def test_max_len_ceiling_matches_reference(ref):
    rng = np.random.default_rng(2)
    tw = Twin(ref, slots=2, max_len=12)
    assert tw.admit([(0, _prompt(rng, 4), 100), (1, _prompt(rng, 7), 100)]) == 2
    tw.drain()
    assert [len(t.out) for _, t in tw.reqs] == [1 + 12 - 4, 1 + 12 - 7]
    assert tw.admit([(2, _prompt(rng, 3), 2)]) == 1       # slots freed at the ceiling
    tw.drain()


def test_max_new_one_matches_reference(ref):
    rng = np.random.default_rng(5)
    tw = Twin(ref, slots=1, max_len=32)
    assert tw.admit([(0, _prompt(rng, 6), 1)]) == 1
    assert tw.tick() is False
    assert tw.reqs[0][1].out and len(tw.reqs[0][1].out) == 1


def test_params_argument_registers_the_tree(ref):
    """``Engine(model, params)`` serves ``params``: a fresh port model given
    the carried tree decodes what the reference decodes."""
    jax = pytest.importorskip("jax")
    model = build_model(narrow(reduced(ARCHS["deepseek-7b"])), "cpu")
    model.init(torch.Generator().manual_seed(7))           # other weights, replaced below
    tree = interop.params_from_numpy(jax.tree.map(np.asarray, ref.jp), device="cpu")
    eng = Engine(model, tree, batch_slots=1, max_len=32)
    jeng = ref.Engine(ref.jm, ref.jp, batch_slots=1, max_len=32)
    p = _prompt(np.random.default_rng(9), 7)
    r, jr = Request(0, p.copy(), max_new=6), ref.Request(0, p.copy(), max_new=6)
    assert eng.admit([r]) == jeng.admit([jr]) == 1
    more = True
    while more:
        more = eng.tick()
        assert jeng.tick() == more
    assert r.out == jr.out and len(r.out) == 6
    assert eng.device == model.device == torch.device("cpu")


def test_positions_are_copied_to_the_model():
    """``tick`` hands the model a copy of ``slot_pos``: bumping the array
    after the call must not move the positions the model was given."""
    model = build_model(narrow(reduced(ARCHS["deepseek-7b"])), "cpu")
    model.init(torch.Generator().manual_seed(0))
    seen = []
    step = model.decode_step

    def spy(step_in, cache, pos):
        seen.append(pos)
        return step(step_in, cache, pos)

    model.decode_step = spy
    eng = Engine(model, batch_slots=2, max_len=16)
    eng.admit([Request(0, np.arange(3, dtype=np.int32), max_new=4)])
    eng.tick()
    eng.tick()
    assert [p.tolist() for p in seen] == [[3, 0], [4, 0]]
    assert eng.slot_pos.tolist() == [5, 0]


# ---------------------------------------------------------------------------
# the reference's serving regressions (tests/test_substrate.py), on the port's
# reduced bf16 model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serving_setup():
    cfg = reduced(ARCHS["deepseek-7b"])
    model = build_model(cfg, "cpu")
    model.init(torch.Generator().manual_seed(0))
    return cfg, model, None


def _solo(model, params, prompt, max_new, *, slots=1, max_len=64):
    eng = Engine(model, params, batch_slots=slots, max_len=max_len)
    req = Request(0, prompt.copy(), max_new=max_new)
    assert eng.admit([req]) == 1
    while eng.tick():
        pass
    return req


def test_serving_engine_batched(serving_setup):
    cfg, model, params = serving_setup
    eng = Engine(model, params, batch_slots=3, max_len=64)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, 8).astype(np.int32), max_new=5)
            for i in range(3)]
    assert eng.admit(reqs) == 3
    ticks = 0
    while eng.tick():
        ticks += 1
        assert ticks < 32
    assert all(len(r.out) == 5 and r.done for r in reqs)


def test_serving_admit_mid_decode_is_bit_stable(serving_setup):
    """An admission while a slot is mid-generation prefills only the free
    slot: the in-flight request's tokens equal an interference-free run, and
    the admitted request equals a clean-engine run."""
    cfg, model, params = serving_setup
    rng = np.random.default_rng(1)
    p1 = rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
    p2 = rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
    ref = _solo(model, params, p1, 6, slots=2)

    eng = Engine(model, params, batch_slots=2, max_len=64)
    r1 = Request(0, p1.copy(), max_new=6)
    assert eng.admit([r1]) == 1
    eng.tick()
    eng.tick()
    r2 = Request(1, p2.copy(), max_new=4)
    assert eng.admit([r2]) == 1          # admitted mid-decode into slot 1
    while eng.tick():
        pass
    assert r1.done and r1.out == ref.out
    assert r2.done and len(r2.out) == 4
    assert r2.out == _solo(model, params, p2, 4, slots=2).out


def test_serving_max_len_truncates_and_frees_slots(serving_setup):
    cfg, model, params = serving_setup
    rng = np.random.default_rng(2)
    eng = Engine(model, params, batch_slots=2, max_len=16)
    r1 = Request(0, rng.integers(0, cfg.vocab_size, 8).astype(np.int32), max_new=100)
    assert eng.admit([r1]) == 1
    while eng.tick():
        pass
    assert r1.done and 0 < len(r1.out) < 100  # truncated at the ceiling
    r2 = Request(1, rng.integers(0, cfg.vocab_size, 4).astype(np.int32), max_new=2)
    assert eng.admit([r2]) == 1               # slot freed, engine still live


def test_serving_ceiling_emits_final_token(serving_setup):
    """Decoding at position p writes KV row p, so the last decodable
    position is max_len - 1: a max_len-bounded run matches a
    max_new-bounded run of the same length."""
    cfg, model, params = serving_setup
    p = np.random.default_rng(3).integers(0, cfg.vocab_size, 4).astype(np.int32)
    bounded = _solo(model, params, p, 100, max_len=12)
    assert len(bounded.out) == 1 + (12 - len(p))   # prefill token + decodes at 4..11
    assert bounded.out == _solo(model, params, p, len(bounded.out), max_len=64).out


def test_serving_admit_mixed_length_batch_matches_sequential(serving_setup):
    cfg, model, params = serving_setup
    rng = np.random.default_rng(4)
    p1 = rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
    p2 = rng.integers(0, cfg.vocab_size, 5).astype(np.int32)
    eng = Engine(model, params, batch_slots=2, max_len=64)
    r1 = Request(0, p1.copy(), max_new=6)
    r2 = Request(1, p2.copy(), max_new=6)
    assert eng.admit([r1, r2]) == 2           # one batch, two prompt lengths
    while eng.tick():
        pass
    for prompt, mixed in ((p1, r1), (p2, r2)):
        assert mixed.out == _solo(model, params, prompt, 6, slots=2).out


def test_serving_max_new_one_emits_exactly_one_token(serving_setup):
    cfg, model, params = serving_setup
    eng = Engine(model, params, batch_slots=1, max_len=32)
    r = Request(0, np.random.default_rng(5).integers(0, cfg.vocab_size, 6).astype(np.int32),
                max_new=1)
    assert eng.admit([r]) == 1
    assert len(r.out) == 1
    assert eng.tick() is False
    assert r.done and len(r.out) == 1

