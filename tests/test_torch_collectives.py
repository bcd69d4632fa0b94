"""The port's compressed cross-pod gradient ring (``repro_torch.distributed``)
and the pipeline's ``mode="spmd"``, on two gloo ranks on the CPU.

One spawn of two ranks (a ``file://`` rendezvous under the test's
``tmp_path``, so parallel test workers cannot clash on a port) runs every
distributed check and returns its outputs; the tests hold them against the
JAX package.  The reference's ``compressed_pod_mean`` runs under
``shard_map`` and its pipeline raises on jax 0.9.0, so the ring is held bit
for bit to its composition written out in ``jnp``: per pod, the other pod's
leaf cast to bf16, its 16-bit words paged, ``fr_encode`` and ``fr_decode``
under the reference's ``GRAD_FR``, added in float32 to the pod's own leaf,
divided by the pod count and cast back.
"""
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch._tree import tree_flatten_with_path, tree_map
from repro_torch.distributed import collectives

GRAD_SHAPES = {"w1": (4096,), "w2": (2048,), "b": (1000,), "h": (3, 700)}
SPMD_FIELDS = dict(word_bits=16, page_words=256, num_bases=6, width_set=(4, 8),
                   cap_profiles=((64, 192), (192, 64)), outlier_cap=16)


def _grads(rank: int) -> dict[str, np.ndarray]:
    """Rank ``rank``'s gradient leaves; ``h`` is bf16 (as uint16 bit patterns)."""
    rng = np.random.default_rng(100 + rank)
    scales = {"w1": 1e-3, "w2": 2e-2, "b": 5e-3, "h": 1e-2}
    out = {k: rng.normal(0, scales[k], shape).astype(np.float32) for k, shape in GRAD_SHAPES.items()}
    out["b"][::7] = 0.0
    return out


def _port_tree(g: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    tree = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
    tree["h"] = tree["h"].to(torch.bfloat16)
    return tree


def _rank_checks(rank: int, world: int, payload: dict) -> dict:
    """Every distributed check on one rank; runs in a spawned process (one
    intra-op thread, as the ``one_thread`` fixture gives the test process)."""
    torch.set_num_threads(1)
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.core.gbdi_fr import FRConfig
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.kernels import pipeline
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw
    from repro_torch.training import train_step

    out: dict = {}
    table = interop.table_from_numpy(*payload["table"], device="cpu")
    grads = _port_tree(_grads(rank))
    stats: dict = {}
    ring = collectives.compressed_pod_mean(grads, table, stats=stats)
    out["ring"] = interop.params_to_numpy(ring)
    out["stats"] = stats
    out["plain"] = interop.params_to_numpy(collectives.plain_pod_mean(grads))
    try:
        collectives.compressed_pod_mean(grads, table, n_pods=3)
    except ValueError as e:
        out["n_pods_error"] = str(e)

    # the train step with the compressed exchange, against its parts
    cfg = reduced(ARCHS["deepseek-7b"])
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(7))
    state = adamw.init_state(params)
    batch = TokenPipeline(PipelineConfig(cfg.vocab_size, 32, 2, seed=1)).batch_at(
        0, host=rank, n_hosts=world)
    acfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = train_step.make_train_step(model, acfg, compress_grads=True, fr_bases=table)
    # the step updates the trees it is given in place: keep the originals
    new_params, _, metrics = step(tree_map(torch.clone, params), tree_map(torch.clone, state),
                                  batch)
    out["step_params"] = interop.params_to_numpy(new_params)
    out["step_loss"] = float(metrics["loss"])
    model.set_params(params)
    loss, grads = train_step._grads(model, batch)
    mean = collectives.compressed_pod_mean(grads, table)
    want, _, _ = adamw.apply_updates(acfg, params, mean, state)
    out["parts_params"] = interop.params_to_numpy(want)
    out["parts_loss"] = float(loss)

    # the pipeline split over the ranks
    scfg = FRConfig(**SPMD_FIELDS)
    stable = interop.table_from_numpy(*payload["spmd_table"], device="cpu")
    x = torch.from_numpy(payload["spmd_pages"])
    blob = pipeline.encode_pages_sharded(x, stable, scfg, mode="spmd")
    out["spmd_blob"] = {k: v.numpy() for k, v in blob.items()}
    out["spmd_words"] = pipeline.decode_pages_sharded(blob, stable, scfg, mode="spmd").numpy()
    return out


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the models and pages here are small, and on a
    host shared with other test workers torch's thread pool spends more time
    contending than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import gbdi_fr
    from repro.distributed import collectives as jcoll

    return SimpleNamespace(jax=jax, jnp=jnp, fr=gbdi_fr, GRAD_FR=jcoll.GRAD_FR)


@pytest.fixture(scope="module")
def spawned(ref, tmp_path_factory):
    from repro_torch.distributed.spawn import run_ranks

    jnp = ref.jnp
    both = [_grads(r) for r in range(2)]
    words = ref.jax.lax.bitcast_convert_type(
        jnp.concatenate([jnp.asarray(g[k]).reshape(-1) for g in both for k in sorted(g)]
                        ).astype(jnp.bfloat16), jnp.uint16).astype(jnp.int32)
    jt = ref.fr.fit_fr_bases(words, ref.GRAD_FR)
    scfg = ref.fr.FRConfig(**SPMD_FIELDS)
    pages = np.random.default_rng(0).integers(-2000, 2000, (37, 256)).astype(np.int32)
    st = ref.fr.fit_fr_bases(jnp.asarray(pages), scfg)
    payload = {"table": (np.asarray(jt.bases), np.asarray(jt.widths)),
               "spmd_table": (np.asarray(st.bases), np.asarray(st.widths)),
               "spmd_pages": pages}
    outs = run_ranks(_rank_checks, 2, payload, init_dir=tmp_path_factory.mktemp("gloo"),
                     timeout_s=600.0)
    spmd_blob = ref.fr.fr_encode(jnp.asarray(pages), st, scfg)
    return SimpleNamespace(outs=outs, both=both, jt=jt, pages=pages,
                           spmd_blob={k: np.asarray(v) for k, v in spmd_blob.items()},
                           spmd_words=np.asarray(ref.fr.fr_decode(spmd_blob, st, scfg)))


def _jnp_ring_mean(ref, both: list[dict], jt, pod: int) -> dict[str, np.ndarray]:
    """The reference's ring, written out in jnp, as pod ``pod`` sees it."""
    jnp, fr, cfg = ref.jnp, ref.fr, ref.GRAD_FR
    n = len(both)
    out = {}
    for k in both[pod]:
        own = jnp.asarray(both[pod][k])
        if k == "h":
            own = own.astype(jnp.bfloat16)
        acc = own.astype(jnp.float32)
        for hop in range(1, n):
            g = jnp.asarray(both[(pod - hop) % n][k])
            flat = g.astype(jnp.bfloat16).reshape(-1)
            w = ref.jax.lax.bitcast_convert_type(flat, jnp.uint16).astype(jnp.int32)
            w = jnp.pad(w, (0, (-w.shape[0]) % cfg.page_words))
            blob = fr.fr_encode(w.reshape(-1, cfg.page_words), jt, cfg)
            dec = fr.fr_decode(blob, jt, cfg).reshape(-1)[:flat.shape[0]]
            back = ref.jax.lax.bitcast_convert_type(dec.astype(jnp.uint16), jnp.bfloat16)
            acc = acc + back.astype(jnp.float32).reshape(g.shape)
        mean = (acc / n).astype(own.dtype)
        out[k] = np.asarray(mean.view(jnp.uint16) if k == "h" else mean)
    return out


@pytest.mark.parametrize("rank", [0, 1])
def test_ring_mean_is_the_reference_composition(ref, spawned, rank):
    want = _jnp_ring_mean(ref, spawned.both, spawned.jt, rank)
    got = spawned.outs[rank]["ring"]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].view(np.uint8), want[k].view(np.uint8), err_msg=k)
    assert got["h"].dtype == np.uint16 and got["w1"].dtype == np.float32


def test_ring_stats_count_the_wire_and_the_drops(ref, spawned):
    cfg = ref.GRAD_FR
    pages = sum(-(-int(np.prod(s)) // cfg.page_words) for s in GRAD_SHAPES.values())
    lanes = cfg.ptr_bits * cfg.page_words // 32 + cfg.page_words * 8 // 32 + 2 * cfg.outlier_cap + 3
    for out in spawned.outs:
        assert out["stats"]["wire_bytes"] == pages * lanes * 4
        assert out["stats"]["n_dropped"] >= 0
        assert "process group has 2 ranks" in out["n_pods_error"]


@pytest.mark.parametrize("rank", [0, 1])
def test_plain_pod_mean_is_the_float32_mean(spawned, rank):
    both = [_port_tree(g) for g in spawned.both]
    for k, got in spawned.outs[rank]["plain"].items():
        want = ((both[0][k].float() + both[1][k].float()) / 2).to(both[0][k].dtype)
        np.testing.assert_array_equal(got, interop.params_to_numpy(want), err_msg=k)


@pytest.mark.parametrize("rank", [0, 1])
def test_compressed_train_step_is_its_parts(spawned, rank):
    """``make_train_step(compress_grads=True)`` = loss + backward, the ring
    mean, then AdamW, bit for bit."""
    out = spawned.outs[rank]
    assert out["step_loss"] == out["parts_loss"] and np.isfinite(out["step_loss"])
    got, want = (tree_flatten_with_path(out[k]) for k in ("step_params", "parts_params"))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    assert spawned.outs[0]["step_loss"] != spawned.outs[1]["step_loss"]   # each rank's batch


@pytest.mark.parametrize("rank", [0, 1])
def test_spmd_pipeline_is_byte_identical(spawned, rank):
    out = spawned.outs[rank]
    assert sorted(out["spmd_blob"]) == sorted(spawned.spmd_blob)
    for k, v in spawned.spmd_blob.items():
        np.testing.assert_array_equal(out["spmd_blob"][k], v, err_msg=k)
    np.testing.assert_array_equal(out["spmd_words"], spawned.spmd_words)


def test_bench_gradcomp_lines_equal_the_reference(ref, capsys):
    import importlib.util

    root = Path(__file__).resolve().parents[1]

    def load(name: str):
        spec = importlib.util.spec_from_file_location(name, root / "benchmarks" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    load("bench_gradcomp").main()
    want = capsys.readouterr().out.splitlines()
    got = load("bench_gradcomp_torch").main(["--device", "cpu"])
    assert got == want and [line.split(",")[0] for line in got] == [
        "gradcomp/wire_bytes", "gradcomp/fidelity"]


def test_world_of_one_returns_the_gradients():
    g = {"a": torch.randn(5000)}
    assert collectives.compressed_crosspod_mean(g, None) is g
    assert collectives.plain_pod_mean(g) is g
    assert collectives.GRAD_FR.num_classes == 1 and collectives.GRAD_FR.word_bits == 16
