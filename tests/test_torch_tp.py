"""Tensor parallelism over 'model' and meshed inference (ROADMAP A17 (iv)):
``LMModel.encode``, ``prefill`` and ``decode_step`` of the port on gloo
ranks on the CPU, against JAX's jitted meshed functions on four
placeholder devices and against the port without a mesh.

* The reduced dense config at float32 (``head_tp`` on 'model' 2) on
  (data, model) meshes (1, 2) and (2, 2) and the pod mesh (2, 1, 2): the
  prefill's logits and 4 teacher-forced decode steps' logits within
  F32_TOL of JAX's and of the unmeshed port, every rank's logits equal,
  ``encode`` within F32_TOL; each rank's cache block after the prefill
  is JAX's shard on the device at the same coordinates, in index and
  shape, its values within CACHE_TOL.
* The moe (GQA: 4 heads, 2 kv heads; 4 experts over 'data'), ssm and
  hybrid smokes at float32 on (2, 2), the moe on (1, 4) (one query head
  a rank, half of a kv head's group), a batch of 1 on (2, 2) (the
  cache's sequence over ('data', 'model')), and a cache of 25 positions
  on (1, 2) (its sequence whole), the same way.
* The dense config at bfloat16 on (2, 2): the logits within the serving
  band (BF16_TOL, rtol = atol) and argmax agreement of at least
  ARGMAX_AGREE over all 84 rows of logits a rank returns (a prefill and
  4 decodes of 4 rows, ``encode``'s 64), against JAX's and the unmeshed
  port's.
* Caches across the mesh: the ranks' blocks gathered back equal the
  unmeshed caches; the unmeshed caches cut into blocks decode as the
  meshed ones.
* The splits are real: on (1, 2) the compute views of ``wq``, ``wo``,
  ``w_gate``, ``w_down`` and ``head`` have JAX's shard shapes, and a
  rank's ``FlopCounterMode`` count of ``encode``'s products is half the
  unmeshed count.
* The dry run's plan of a meshed decode step (``dryrun.lower_lm_cell``
  on a ``PlanMesh``) equals each real rank's ``LMMesh.stats``, calls and
  bytes, kind by kind, on (1, 2), (2, 2), the pod mesh, and for the moe.

One subprocess spawns four gloo ranks that run every case
(``tests/torch_train_mesh_ranks.py``); another runs JAX
(``tests/torch_mesh_jax.py``); both start when the module does.
"""
import numpy as np
import pytest

from repro_torch.configs import ShapeCell
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import plan_mesh
from torch_train_mesh_ranks import (INFER_MAX_LEN, config, infer, start,
                                    tp_views)
from torch_workloads import one_torch_thread  # noqa: F401  (autouse)

F32_TOL = 1e-4
CACHE_TOL = 1e-5
BF16_TOL = 0.15
ARGMAX_AGREE = 0.95
AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")
# name -> (family, dtype, mesh shape, axes, (batch, prompt)[, max_len])
CASES = {
    "dense/1x2": ("dense", "float32", (1, 2), AXES, (4, 16)),
    "dense/2x2": ("dense", "float32", (2, 2), AXES, (4, 16)),
    "dense/pod": ("dense", "float32", (2, 1, 2), POD_AXES, (4, 16)),
    "moe/2x2": ("moe", "float32", (2, 2), AXES, (4, 16)),
    "moe/1x4": ("moe", "float32", (1, 4), AXES, (4, 16)),
    "ssm/2x2": ("ssm", "float32", (2, 2), AXES, (4, 16)),
    "hybrid/2x2": ("hybrid", "float32", (2, 2), AXES, (4, 16)),
    "one/2x2": ("dense", "float32", (2, 2), AXES, (1, 16)),
    "odd/1x2": ("dense", "float32", (1, 2), AXES, (4, 16), 25),
    "bf16/2x2": ("dense", "bfloat16", (2, 2), AXES, (4, 16)),
}
F32 = sorted(k for k in CASES if not k.startswith("bf16"))
PLANNED = ["dense/1x2", "dense/2x2", "dense/pod", "moe/2x2"]


def _kw(name):
    fam, dtype, shape, axes, batch, *max_len = CASES[name]
    return dict(fam=fam, dtype=dtype, shape=shape, axes=axes, batch=batch,
                max_len=max_len[0] if max_len else INFER_MAX_LEN)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    torch_cases = {n: ("infer", _kw(n)) for n in CASES}
    torch_cases["views"] = ("tp_views", dict(shape=(1, 2), axes=AXES))
    jax_cases = {n: ("infer", _kw(n)) for n in CASES}
    jax_cases["shards"] = ("shard_shapes", dict(
        fam="dense", dtype="float32", shape=(1, 2), axes=AXES))
    get, stop = start(d, torch_cases, jax_cases)
    yield get
    stop()


@pytest.fixture(scope="module")
def unmeshed():
    cache = {}

    def get(name):
        kw = _kw(name)
        key = (kw["fam"], kw["dtype"], kw["batch"], kw["max_len"])
        if key not in cache:
            cache[key] = infer(kw["fam"], kw["dtype"], None, None,
                               batch=kw["batch"], max_len=kw["max_len"])
        return cache[key]
    return get


def _ranks(runs, name):
    shape = CASES[name][2]
    n = int(np.prod(shape))
    got = [r[name] for r in runs("torch")]
    assert all(g is None for g in got[n:])
    return got[:n]


def _logits(out) -> list:
    return [out["prefill"], *out["decode"], out["encode"]]


@pytest.mark.parametrize("name", F32)
@pytest.mark.parametrize("against", ["jax", "port"])
def test_f32_logits(runs, unmeshed, name, against):
    ranks = _ranks(runs, name)
    want = runs("jax")[name] if against == "jax" else unmeshed(name)
    for r in ranks:
        assert len(r["decode"]) == len(want["decode"])
        for a, b in zip(_logits(r), _logits(want)):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=F32_TOL, atol=F32_TOL,
                                       err_msg=name)
        # every rank returns the whole batch's logits, the same ones
        for a, b in zip(_logits(r), _logits(ranks[0])):
            assert np.array_equal(a, b), (name, r["coords"])


@pytest.mark.parametrize("name", F32)
def test_cache_blocks_are_jax_shards(runs, name):
    """Each rank's block of every cache leaf after the prefill: JAX's
    shard on the device at the rank's coordinates, in index and shape."""
    axes = CASES[name][3]
    ranks = _ranks(runs, name)
    shards = runs("jax")[name]["shards"]
    assert tuple(runs("jax")[name]["layout"]) == tuple(ranks[0]["layout"])
    for r in ranks:
        coords = tuple(r["coords"][a] for a in axes)
        assert sorted(r["blocks"]) == sorted(shards), name
        for leaf, (index, values) in r["blocks"].items():
            j_index, j_values = shards[leaf][coords]
            assert [tuple(i) for i in index] == [tuple(i) for i in j_index], \
                (name, leaf, coords)
            assert values.shape == j_values.shape
            np.testing.assert_allclose(values, j_values, rtol=CACHE_TOL,
                                       atol=CACHE_TOL, err_msg=f"{name} {leaf}")


@pytest.mark.parametrize("name", ["dense/2x2", "hybrid/2x2", "one/2x2"])
def test_caches_carried_across(runs, unmeshed, name):
    """``convert.caches_from_mesh`` puts the ranks' blocks back together
    into the unmeshed port's caches (within CACHE_TOL); a decode step
    from ``convert.caches_to_mesh`` of the unmeshed caches gives the
    meshed decode's first logits (within F32_TOL) on every rank."""
    ranks = _ranks(runs, name)
    want = unmeshed(name)
    gathered = ranks[0]["gathered"]
    assert sorted(gathered) == sorted(want["blocks"])
    for leaf, got in gathered.items():
        np.testing.assert_allclose(got, want["blocks"][leaf][1],
                                   rtol=CACHE_TOL, atol=CACHE_TOL,
                                   err_msg=f"{name} {leaf}")
    for r in ranks:
        np.testing.assert_allclose(r["carried"], r["decode"][0],
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=name)


def test_layouts(runs):
    """The layouts the cases exercise: heads split on 'model' 2 (the moe
    with GQA too), and a batch of 1 that does not split over 'data', so
    the cache's sequence lies over ('data', 'model')."""
    lay = {n: tuple(_ranks(runs, n)[0]["layout"]) for n in F32}
    assert lay["dense/2x2"] == ("data", "model", "model")
    assert lay["dense/pod"] == (("pod", "data"), "model", "model")
    assert lay["moe/2x2"] == ("data", "model", "model")
    assert lay["moe/1x4"] == ("data", "model", "model")
    assert lay["one/2x2"] == (None, "model", ("data", "model"))
    # 25 positions do not split over 'model' 2: the cache's sequence is
    # whole, every head gathered into it at the prefill
    assert lay["odd/1x2"] == ("data", "model", None)
    assert config("moe", "float32").n_kv_heads < config(
        "moe", "float32").n_heads


@pytest.mark.parametrize("against", ["jax", "port"])
def test_bf16_serving_band(runs, unmeshed, against):
    name = "bf16/2x2"
    ranks = _ranks(runs, name)
    want = runs("jax")[name] if against == "jax" else unmeshed(name)
    rows = lambda out: np.concatenate([  # noqa: E731
        x.reshape(-1, x.shape[-1]) for x in _logits(out)])
    for r in ranks:
        for a, b in zip(_logits(r), _logits(want)):
            assert np.all(np.isfinite(a))
            np.testing.assert_allclose(a, b, rtol=BF16_TOL, atol=BF16_TOL)
        # over every logit row the case returns (prefill, decode, encode)
        agree = float((rows(r).argmax(-1) == rows(want).argmax(-1)).mean())
        assert agree >= ARGMAX_AGREE, agree
        for a, b in zip(_logits(r), _logits(ranks[0])):
            assert np.array_equal(a, b)


SPLIT_VIEWS = ("blocks/attn/wq", "blocks/attn/wo", "blocks/ffn/w_gate",
               "blocks/ffn/w_down", "head")


def test_splits_are_real(runs):
    """(1, 2): the compute views of the split weights are JAX's shards
    (the leading layer dimension off), half of the whole weight, and each
    rank counts half the unmeshed products' FLOPs, op by op."""
    from repro_torch.models.layers import tree_flatten_with_path
    from repro_torch.models.lm import LMModel

    whole_params, _ = LMModel(config("dense", "float32"),
                              device="meta").abstract_params()
    whole_shapes = {"/".join(map(str, p)): tuple(t.shape)
                    for p, t in tree_flatten_with_path(whole_params)}
    shards = runs("jax")["shards"]
    views = [r["views"] for r in runs("torch")[:2]]
    for v in views:
        for name in SPLIT_VIEWS:
            lead = 1 if name.startswith("blocks/") else 0
            assert v["views"][name] == shards[name][lead:], name
            assert 2 * np.prod(v["views"][name]) == np.prod(
                whole_shapes[name][lead:]), name
    whole = tp_views(None, None)["flops"]
    assert whole and all(n > 0 for n in whole.values())
    for v in views:
        assert sorted(v["flops"]) == sorted(whole)
        for op, n in whole.items():
            assert 2 * v["flops"][op] == n, op


@pytest.mark.parametrize("name", PLANNED)
def test_planned_decode_step(runs, name):
    """The plan of one decode step of the case's caches (a decode cell of
    the case's batch and max_len) on each rank's ``PlanMesh``: every
    kind's calls and bytes are the real rank's last decode step's."""
    fam, dtype, shape, axes, (batch, _), *_ = CASES[name]
    cell = ShapeCell("decode", INFER_MAX_LEN, batch, "decode")
    for real in _ranks(runs, name):
        _, _, plan = dryrun.lower_lm_cell(
            "smoke-lm", cell, plan_mesh(shape, axes, real["rank"]),
            cfg=config(fam, dtype))
        planned = plan["mesh"].calls_and_bytes()
        assert planned == real["decode_stats"], (name, real["rank"])
        assert {"tp", "cache", "logits"} <= set(planned), planned
