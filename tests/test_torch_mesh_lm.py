"""The LM meshes of the port (``repro_torch.launch.mesh``: ``LMMesh``,
``make_smoke_mesh``, ``make_production_mesh``, ``make_mesh_compat``,
``make_selfjoin_mesh``; ROADMAP A17 (ii b)), the spec placements and the
``shard`` cut point (``models/layers.py``), and the checkpoints' elastic
path across meshes.

The constructors run on gloo ranks at worlds 1, 2 and 4 and are held to
JAX's ``make_smoke_mesh`` on placeholder devices (shapes and axis names);
the production meshes are refused with both counts. Blocks and gathers on
(2, 2) and (2, 1, 2) meshes (an entry of two axes split with its first
axis major, as JAX's ``PartitionSpec``), the all-to-all of ``shard`` and
its gradient.
A checkpoint saved on one rank restores onto four with ``('data',
None)`` (the counterpart of ``tests/test_ckpt.py::
test_elastic_restore_subprocess``); a checkpoint written from four ranks
reads back in JAX's ``restore_checkpoint``. Inference on a mesh of ranks
runs, and refuses what it cannot do on every rank alike.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import restore_checkpoint as j_restore
from repro_torch.ckpt import save_checkpoint
from repro_torch.models.layers import (current_mesh, mesh_context,
                                       placements, shard)
from torch_train_mesh_ranks import start
from torch_workloads import one_torch_thread  # noqa: F401  (autouse)

AXES2 = ("data", "model")
AXES3 = ("pod", "data", "model")
SPECS = [("data", "model"), (None, "data"), ((("pod", "data")), None),
         ("model", None, "data"), ()]


def worlds_cases(tmp):
    shapes = {"shapes": ("mesh_shapes", {})}
    return {1: dict(shapes),
            2: dict(shapes, infer=("inference_refused",
                                   dict(shape=(1, 2), axes=AXES2))),
            4: dict(shapes,
                    restore=("restore", dict(directory=str(tmp / "one"),
                                             step=7, shape=(4,),
                                             axes=("data",),
                                             spec=("data", None))),
                    blocks2=("blocks", dict(shape=(2, 2), axes=AXES2,
                                            specs=SPECS[:2] + SPECS[3:]
                                            + [(("model", "data"),)])),
                    blocks3=("blocks", dict(shape=(2, 1, 2), axes=AXES3,
                                            specs=SPECS)),
                    moved=("moved", dict(shape=(2, 2), axes=AXES2,
                                         batch_axes="data")),
                    save=("save", dict(directory=str(tmp / "four"),
                                       fam="dense", dtype="bfloat16",
                                       shape=(2, 2), axes=AXES2)))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_lm")
    save_checkpoint(str(d / "one"), 7, {
        "w": torch.arange(32, dtype=torch.float32).reshape(8, 4)})
    get, stop = start(d, worlds_cases(d), {"shapes": ("mesh_shapes", {})},
                      n_ranks=0)
    yield get, d
    stop()


@pytest.mark.parametrize("world", [1, 2, 4])
def test_smoke_mesh_against_jax(runs, world):
    get, _ = runs
    ranks = get("torch")[world]
    jax_shapes = get("jax")["shapes"]
    for rank, r in enumerate(ranks):
        names, shape, coords = r["shapes"]["smoke_world"]
        assert (names, shape) == jax_shapes[world]
        # row-major ranks, as jax.make_mesh lays the CPU devices out
        assert coords == {"data": rank // shape["model"],
                          "model": rank % shape["model"]}
        assert r["shapes"]["smoke_8"][:2] == jax_shapes[min(8, world)]
        assert r["shapes"]["compat"][:2] == (("data",), {"data": world})
    # make_smoke_mesh(2) over the first two ranks; the others are outside
    for rank, r in enumerate(ranks):
        got = r["shapes"]["smoke_2"]
        if rank < min(2, world):
            assert got[:2] == jax_shapes[min(2, world)]
        else:
            assert got is None


@pytest.mark.parametrize("world", [1, 2, 4])
def test_production_meshes_refused(runs, world):
    get, _ = runs
    r = get("torch")[world][0]["shapes"]
    assert r["single"] == ("error", "ValueError",
                           f"a (16, 16) mesh over ('data', 'model') needs "
                           f"256 ranks, the world has {world}")
    assert r["multi"][2] == (f"a (2, 16, 16) mesh over ('pod', 'data', "
                             f"'model') needs 512 ranks, the world has "
                             f"{world}")
    assert r["selfjoin"] == ("error", "ValueError",
                             f"a (16, 16) slab mesh needs 256 ranks, the "
                             f"group has {world}")
    # JAX refuses them on its four devices too
    assert get("jax")["shapes"]["single"] is not None


def test_inference_refused_on_mesh_of_ranks(runs):
    """``encode``, ``prefill`` and ``decode_step`` run on a (1, 2) mesh of
    ranks (ROADMAP A17 (iv); their values: ``test_torch_tp.py``) and
    return the whole batch's logits. A decode past the caches' max_len
    (C7) and a prompt longer than it raise ValueError on every rank,
    before any collective (a rank that raised alone would leave the other
    waiting). A copy of the caches decodes as the caches do: their layout
    comes from the ``max_len`` they carry."""
    get, _ = runs
    for r in get("torch")[2]:
        assert r["infer"]["ran"] == {"encode": (2, 8, 512),
                                     "prefill": (2, 512), "decode": (2, 512)}
        assert r["infer"]["decode_past_max_len"] == (
            "ValueError", "decode at position 8 past the KV cache's max_len "
            "8: allocate the cache for the prompt and every decoded token")
        assert r["infer"]["prompt_past_max_len"] == (
            "ValueError", "a prompt of 8 tokens does not fit a KV cache of "
            "max_len 4")


def fake(names):
    return types.SimpleNamespace(axis_names=names)


@pytest.mark.parametrize("spec, names, want", [
    (("data", "model"), AXES2, ["S0", "S1"]),
    (("model", "data"), AXES2, ["S1", "S0"]),
    (("data", None), AXES2, ["S0", "R"]),
    ((None, None), AXES2, ["R", "R"]),
    ((), AXES2, ["R", "R"]),
    (((("pod", "data")), None, "model"), AXES3, ["S0", "S0", "S2"]),
    ((None, "model"), AXES3, ["R", "R", "S1"]),
])
def test_spec_to_placements(spec, names, want):
    from torch.distributed.tensor.placement_types import Replicate, Shard
    made = {"R": Replicate()} | {f"S{d}": Shard(d) for d in range(3)}
    assert placements(spec, fake(names)) == [made[w] for w in want]


@pytest.mark.parametrize("spec", [("pod", None), ("data", "data")])
def test_spec_refused(spec):
    with pytest.raises(ValueError):
        placements(spec, fake(AXES2))


def test_shard_identity_off_mesh():
    assert current_mesh() is None
    x = torch.randn(4, 3, 2, requires_grad=True)
    assert shard(x, "data", None, "model") is x
    assert shard(x, None, "data", None, src=("data",)) is x
    with mesh_context(None, "data"):
        assert current_mesh() is None
        assert shard(x, "data", None, None) is x


def test_blocks_and_gathers(runs):
    get, _ = runs
    whole = np.arange(8 * 4 * 6, dtype=np.float32).reshape(8, 4, 6)
    for case, names in (("blocks2", AXES2), ("blocks3", AXES3)):
        ranks = get("torch")[4]
        seen = {}
        for r in ranks:
            out = r[case]
            c = out["coords"]
            for spec, got in out.items():
                if spec == "coords":
                    continue
                assert np.array_equal(got["back"], whole), (case, spec)
                idx = []
                for entry, size in zip(spec + (None,) * 3, whole.shape):
                    axes = (entry if isinstance(entry, tuple)
                            else () if entry is None else (entry,))
                    i, n = 0, 1
                    for a in axes:
                        k = dict(zip(names, (2, 1, 2) if len(names) == 3
                                     else (2, 2)))[a]
                        i, n = i * k + c[a], n * k
                    idx.append(slice(i * size // n, (i + 1) * size // n))
                assert np.array_equal(got["block"], whole[tuple(idx)])
                seen.setdefault(spec, []).append(got["owner"])
        for spec, owners in seen.items():
            named = {a for e in spec for a in
                     (e if isinstance(e, tuple) else (e,)) if a}
            copies = 1
            for a, k in zip(names, (2, 1, 2) if len(names) == 3 else (2, 2)):
                if a not in named:
                    copies *= k
            assert sum(owners) == 4 // copies, (case, spec)


def test_shard_moves_batch_axis(runs):
    """(4, 4, 3) rows over 'data' on a (2, 2) mesh: ``shard(x, None,
    'data', None)`` gives every row of the rank's dimension-1 block;
    back again is x; the gradient of sum(y^2) is 2x."""
    get, _ = runs
    whole = np.arange(48, dtype=np.float32).reshape(4, 4, 3)
    for r in get("torch")[4]:
        m = r["moved"]
        d = m["coords"]["data"]
        assert m["same_is_x"]
        assert np.array_equal(m["x"], whole[2 * d:2 * d + 2])
        assert np.array_equal(m["there"], whole[:, 2 * d:2 * d + 2])
        assert np.array_equal(m["back"], m["x"])
        assert np.array_equal(m["grad"], 2 * m["x"])


def test_elastic_restore_one_rank_onto_four(runs):
    get, _ = runs
    whole = np.arange(32, dtype=np.float32).reshape(8, 4)
    got = [r["restore"] for r in get("torch")[4]]
    for rank, r in enumerate(got):
        assert r["coords"] == {"data": rank}
        assert np.array_equal(r["block"], whole[2 * rank:2 * rank + 2])
    assert np.array_equal(np.concatenate([r["block"] for r in got]), whole)


def test_four_rank_checkpoint_reads_in_jax(runs):
    get, d = runs
    ranks = get("torch")[4]
    saved = ranks[0]["save"]
    assert saved["files"] == ["step_00000002"]
    assert all(r["save"]["tree"] is None for r in ranks[1:])
    import jax
    # the ranks' bfloat16 leaves arrive as their uint16 bits
    like = jax.tree.map(lambda a: a.view(jnp.bfloat16)
                        if a.dtype == np.uint16 else a, saved["tree"])
    got = j_restore(str(d / "four"), 2, like)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree_util.tree_leaves(like)):
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
        assert np.array_equal(np.asarray(a).reshape(-1).view(np.uint8),
                              np.asarray(b).reshape(-1).view(np.uint8)), path
