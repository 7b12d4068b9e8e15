"""spacer_tpu_torch/parallel on the CPU: the mesh, the partition rules and
batch placement against spacer_tpu/parallel, and the collectives in gloo
process groups of 2 and 4 spawned processes (parallel.multihost.
launch_local, each run limited to TIMEOUT seconds):

- `mesh_shape_for` equals JAX's, and rank r sits where JAX's create_mesh
  puts device r;
- the rule tables are JAX's (specs as tuples);
- `place_batch` gives each rank the rows JAX's place_batch gives the
  device of the same index on the conftest's 8-device CPU mesh (dim-1
  batch keys, replicated keys, dims that do not divide);
- `all_gather_objects`, `broadcast_from_host0`, `mean_across_hosts`,
  `fetch_to_host` (over data x fsdp and over data) and
  `global_batch_from_local` across ranks;
- `shard_params` then a gather gives back every tensor bitwise, on a
  (fsdp) and a (data, fsdp) mesh; the gather's backward reduce-scatters
  the gradients summed over the ranks; `fsdp.global_norm` is the full
  gradients' norm.

The spawned workers import only torch, numpy and spacer_tpu_torch (jax is
imported inside the tests that compare with it)."""

import os
import pickle

import numpy as np
import pytest
import torch

from spacer_tpu_torch.parallel import fsdp, multihost
from spacer_tpu_torch.parallel import partition as tpart
from spacer_tpu_torch.parallel.mesh import Mesh, create_mesh, mesh_shape_for

TIMEOUT = 120


# -- in one process, against JAX ---------------------------------------------


@pytest.mark.parametrize("n,tp,fsdp_size", [
    (1, 1, None), (2, 1, None), (4, 1, None), (8, 1, None), (8, 2, None),
    (8, 1, 2), (8, 1, 4), (8, 2, 2), (6, 1, 3), (4, 4, None)])
def test_mesh_shape_for_matches_jax(n, tp, fsdp_size):
    from spacer_tpu.parallel.mesh import mesh_shape_for as jax_shape_for

    assert mesh_shape_for(n, tp, fsdp_size) == jax_shape_for(n, tp, fsdp_size)


@pytest.mark.parametrize("shape", [
    {"data": 2, "fsdp": 4}, {"data": 4, "fsdp": 2}, {"fsdp": 8},
    {"data": 8}, {"data": 1, "fsdp": 2}])
def test_rank_coords_match_jax_device_positions(cpu_devices, shape):
    from spacer_tpu.parallel.mesh import create_mesh as jax_create_mesh

    n = int(np.prod(list(shape.values())))
    jmesh = jax_create_mesh(shape, devices=cpu_devices[:n])
    for idx in np.ndindex(jmesh.devices.shape):
        rank = cpu_devices.index(jmesh.devices[idx])
        assert tuple(Mesh(shape, rank).coords.values()) == idx


def test_tp_meshes_raise():
    """Since tensor parallelism was ported a tp Mesh constructs, tp the
    fastest axis (tests/test_torch_tp.py holds it against JAX's); only
    create_mesh without a process group raises."""
    mesh = Mesh({"data": 1, "fsdp": 2, "tp": 2}, 3)
    assert mesh.coords == {"data": 0, "fsdp": 1, "tp": 1}
    assert mesh.shape == {"data": 1, "fsdp": 2, "tp": 2} and mesh.size == 4
    assert mesh.batch_index == 1
    with pytest.raises(RuntimeError, match="initialized process group"):
        create_mesh({"fsdp": 1, "tp": 2})


def test_serving_and_evaluation_refuse_a_mesh():
    """Serving and evaluation run over a mesh since tensor parallelism was
    ported (tests/test_torch_tp_serving.py), the Aria family's too since
    its tp plan was (tests/test_torch_aria_tp.py): what still refuses a tp
    mesh is a tp that does not divide the family's heads or widths, in its
    tp plan and the Sampler its engines build (ValueError)."""
    from spacer_tpu_torch.models.aria import tiny_aria_config
    from spacer_tpu_torch.models.registry import get_family
    from spacer_tpu_torch.sampler import Sampler

    aria = tiny_aria_config()
    tp_mesh = Mesh({"tp": 2}, 0)
    assert get_family("aria").tp_plan(aria, 2).experts is None
    assert Sampler(aria, mesh=tp_mesh).mesh.shape["tp"] == 2
    with pytest.raises(ValueError, match="does not divide"):
        get_family("aria").tp_plan(aria, 4)
    with pytest.raises(ValueError, match="does not divide"):
        Sampler(aria, mesh=Mesh({"tp": 4}, 0))
    assert Sampler(aria, mesh=Mesh({"fsdp": 2}, 0)).mesh.shape["tp"] == 1
    qwen = get_family("qwen").tiny_config()
    assert Sampler(qwen, mesh=tp_mesh).mesh.coords["tp"] == 0


def test_rules_are_jaxs():
    from spacer_tpu.parallel import partition as jpart

    for mine, theirs in ((tpart.QWEN_PARTITION_RULES,
                          jpart.QWEN_PARTITION_RULES),
                         (tpart.ARIA_PARTITION_RULES,
                          jpart.ARIA_PARTITION_RULES)):
        assert [(p, tuple(s)) for p, s in mine] == [
            (p, tuple(s)) for p, s in theirs]
    assert tpart._BATCH_DIM1_KEYS == jpart._BATCH_DIM1_KEYS
    assert tpart._REPLICATED_KEYS == jpart._REPLICATED_KEYS


def test_which_leaves_shard():
    """The port's per-layer leaves take JAX's stacked specs minus the layer
    axis; a leaf is sharded iff its spec names fsdp, except per-layer
    tensors of a size that is not a multiple of 2048 (one moment group
    across layers)."""
    from spacer_tpu_torch.models.registry import get_family

    for fam in ("qwen", "aria"):
        family = get_family(fam)
        cfg = family.tiny_config()
        params = family.init_params(cfg, seed=0)
        mesh = Mesh({"fsdp": 2}, 0, groups=None)
        sharded, specs = tpart.shard_params(params, mesh,
                                            family.partition_rules)
        names = dict(tpart._named_leaves(sharded))
        spec_of = dict(tpart._named_leaves(specs))
        assert spec_of["model/layers/1/self_attn/q_proj/kernel"] == (
            "fsdp", "tp")
        assert spec_of["model/embed_tokens/embedding"] == ("tp", "fsdp")
        assert spec_of["model/norm/scale"] == ()
        for path, full in tpart._named_leaves(params):
            stacked = tpart._unstacked(path)[1]
            want = "fsdp" in spec_of[path] and not (
                stacked and full.numel() % 2048)
            assert isinstance(names[path], fsdp.Shard) == want, path
        assert isinstance(names["model/embed_tokens/embedding"], fsdp.Shard)
        assert not isinstance(names["model/layers/0/input_layernorm/scale"],
                              fsdp.Shard)


def _placement_batch():
    rng = np.random.default_rng(0)
    return {
        "prompt_ids": rng.integers(0, 99, (4, 6)),
        "prompt_position_ids": rng.integers(0, 99, (3, 4, 6)),
        "completion_ids": rng.integers(0, 99, (16, 5)),
        "completion_position_ids": rng.integers(0, 99, (3, 16, 5)),
        "completion_mask": rng.integers(0, 2, (16, 5)),
        "advantages": rng.normal(size=(16,)).astype(np.float32),
        "position_ids": rng.integers(0, 99, (3, 8, 5)),
        "pixel_values": rng.normal(size=(8, 12)).astype(np.float32),
        "patch_mask": rng.integers(0, 2, (8, 12)).astype(bool),
        "odd_rows": rng.normal(size=(6, 3)).astype(np.float32),
    }


@pytest.mark.parametrize("shape", [
    {"data": 2, "fsdp": 4}, {"data": 1, "fsdp": 8}, {"data": 8, "fsdp": 1},
    {"data": 2, "fsdp": 2}, {"data": 1, "fsdp": 2}])
def test_place_batch_matches_jax(cpu_devices, shape):
    from spacer_tpu.parallel.mesh import create_mesh as jax_create_mesh
    from spacer_tpu.parallel.partition import place_batch as jax_place

    n = int(np.prod(list(shape.values())))
    jmesh = jax_create_mesh(shape, devices=cpu_devices[:n])
    batch = _placement_batch()
    placed = jax_place(batch, jmesh)
    for key, arr in placed.items():
        for shard in arr.addressable_shards:
            rank = cpu_devices.index(shard.device)
            mine = tpart.place_batch(batch, Mesh(shape, rank))[key]
            np.testing.assert_array_equal(np.asarray(mine),
                                          np.asarray(shard.data), err_msg=key)
    # place_global_batch is place_batch over a mesh, the batch itself
    # without one
    assert multihost.place_global_batch(batch, None) is batch
    mine = multihost.place_global_batch(batch, Mesh(shape, n - 1))
    theirs = tpart.place_batch(batch, Mesh(shape, n - 1))
    for key in batch:
        np.testing.assert_array_equal(mine[key], theirs[key])
    # tensors are placed the same way
    t = tpart.place_batch({"completion_ids": torch.arange(16)},
                          Mesh({"fsdp": 4}, 3))["completion_ids"]
    assert t.tolist() == [12, 13, 14, 15]


# -- across processes (gloo) ---------------------------------------------------


def _accumulated_update(mesh=None):
    """Two MultiSteps(k=2) mini-steps of int8-moment AdamW whose clip is
    active, on one (64, 128) tensor: the whole tensor without a mesh, this
    rank's blocks of it (gathered back) with one."""
    from spacer_tpu_torch.train.optimizer import MultiSteps, make_optimizer

    gen = torch.Generator().manual_seed(0)
    w, g1, g2 = (torch.randn((64, 128), generator=gen) for _ in range(3))
    tx = MultiSteps(make_optimizer(learning_rate=1e-2, total_steps=4,
                                   max_grad_norm=0.1, moment_dtype="int8",
                                   seed=5), 2)
    if mesh is None:
        state = tx.init([w], ["model/lm_head/kernel"])
        for g in (g1, g2):
            state = tx.apply([g.clone()], state, [w])
        return w
    shard = fsdp.Shard.from_full(w, mesh)
    state = tx.init([shard.data], ["model/lm_head/kernel"],
                    blocks=fsdp.shard_blocks({"w": shard}))

    def norm(gs):
        return fsdp.global_norm(gs, [shard], mesh)

    for g in (g1, g2):
        state = tx.apply([fsdp.Shard.from_full(g, mesh).data], state,
                         [shard.data], norm=norm)
    return shard.full()


def _collectives_worker(rank, out_dir):
    from spacer_tpu_torch.models.qwen25_vl import init_params, tiny_config
    from spacer_tpu_torch.parallel.partition import (
        QWEN_PARTITION_RULES,
        shard_params,
    )
    from spacer_tpu_torch.train.step import param_leaves

    world = multihost.process_count()
    res = {"world": world}
    res["objects"] = multihost.all_gather_objects({"rank": rank,
                                                   "text": "x" * rank})
    res["broadcast"] = multihost.broadcast_from_host0(f"from {rank}")
    res["mean"] = multihost.mean_across_hosts(float(rank) ** 2)

    meshes = {"fsdp": create_mesh({"fsdp": world})}
    if world == 4:
        meshes["data_fsdp"] = create_mesh({"data": 2, "fsdp": 2})
    cfg = tiny_config()
    full = init_params(cfg, seed=0)
    for name, mesh in meshes.items():
        local = torch.arange(6 * 2).reshape(2, 6) + 100 * mesh.batch_index
        res[f"fetch_batch_{name}"] = multihost.fetch_to_host(local, mesh)
        res[f"fetch_dataaxis_{name}"] = multihost.fetch_to_host(
            local + 1000 * mesh.coords["data"] - 100 * mesh.batch_index,
            mesh, axes=("data",))
        sharded, _ = shard_params(full, mesh, QWEN_PARTITION_RULES)
        back = fsdp.gather_params(sharded)
        res[f"bitwise_{name}"] = all(
            torch.equal(a, b) and a.dtype == b.dtype
            for (_, a), (_, b) in zip(param_leaves(full),
                                      param_leaves(back)))
        res[f"n_shards_{name}"] = sum(
            isinstance(x, fsdp.Shard) for x in fsdp.raw_leaves(sharded))
        # the gather's backward: d/dw sum(w * c_r) summed over ranks = sum c_r
        shard = sharded["model"]["layers"][0]["mlp"]["up_proj"]["kernel"]
        data = shard.data.detach().requires_grad_(True)
        c = torch.full(shard.shape, float(rank + 1))
        w = fsdp._Gather.apply(data, shard)
        (g,) = torch.autograd.grad((w * c).sum(), [data])
        res[f"grad_{name}"] = (g, shard.block_lo, shard.nb_full)
        # the norm of the full gradients: a Shard leaf and a replicated one
        rep = torch.full((5,), 2.0)
        res[f"norm_{name}"] = float(fsdp.global_norm(
            [g, rep], [shard, rep], mesh))
    res["multisteps"] = _accumulated_update(meshes["fsdp"])
    res["local_batch"] = multihost.global_batch_from_local(
        {"x": np.full((1, 3), rank)}, meshes["fsdp"])["x"]
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def collective_runs(tmp_path_factory):
    out = {}
    for world in (2, 4):
        d = tmp_path_factory.mktemp(f"collectives{world}")
        multihost.launch_local(_collectives_worker, world, args=(str(d),),
                               device="cpu", timeout=TIMEOUT, threads=1)
        out[world] = [pickle.load(open(d / f"rank{r}.pkl", "rb"))
                      for r in range(world)]
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_object_collectives(collective_runs, world):
    runs = collective_runs[world]
    expect = [{"rank": r, "text": "x" * r} for r in range(world)]
    for r, res in enumerate(runs):
        assert res["world"] == world
        assert res["objects"] == expect
        assert res["broadcast"] == "from 0"
        assert res["mean"] == pytest.approx(np.mean(np.arange(world) ** 2))
        np.testing.assert_array_equal(res["local_batch"], np.full((1, 3), r))


@pytest.mark.parametrize("world", [2, 4])
def test_fetch_to_host(collective_runs, world):
    runs = collective_runs[world]
    for name in ("fsdp", "data_fsdp") if world == 4 else ("fsdp",):
        D = 2 if name == "data_fsdp" else 1
        rows = np.concatenate([np.arange(12).reshape(2, 6) + 100 * i
                               for i in range(world)])
        data_rows = np.concatenate([np.arange(12).reshape(2, 6) + 1000 * d
                                    for d in range(D)])
        for res in runs:
            np.testing.assert_array_equal(res[f"fetch_batch_{name}"], rows)
            np.testing.assert_array_equal(res[f"fetch_dataaxis_{name}"],
                                          data_rows)


@pytest.mark.parametrize("world", [2, 4])
def test_shard_params_then_gather_is_bitwise(collective_runs, world):
    for res in collective_runs[world]:
        for name in ("fsdp", "data_fsdp") if world == 4 else ("fsdp",):
            assert res[f"bitwise_{name}"], name
            assert res[f"n_shards_{name}"] > 10


@pytest.mark.parametrize("world", [2, 4])
def test_gather_backward_and_global_norm(collective_runs, world):
    runs = collective_runs[world]
    for name in ("fsdp", "data_fsdp") if world == 4 else ("fsdp",):
        total = float(sum(r + 1 for r in range(world)))
        grads = []
        for res in runs:
            g, lo, nb = res[f"grad_{name}"]
            rows = g.shape[0]
            real = max(0, min(rows, nb - lo))
            # every element of the rank's blocks gets the sum of the c_r;
            # the zero padding past the tensor's end gets nothing
            assert torch.all(g[:real] == total), name
            assert torch.all(g[real:] == 0), name
            grads.append(g[:real].reshape(-1))
        numel = 64 * 128
        full_sq = total ** 2 * numel + 4.0 * 5
        for res in runs:
            assert res[f"norm_{name}"] == pytest.approx(np.sqrt(full_sq),
                                                        rel=1e-6)


# -- the port's launch scripts -------------------------------------------------


def _script_argv(path):
    """(module, argv) of a launch script's torchrun (or python -m) line,
    shell defaults resolved ("${X:-d}" -> d, "$NPROC" -> 8, "$TP" -> 1)."""
    import re
    import shlex

    text = open(path).read()
    text = re.sub(r"\$\{\w+:-([^}]*)\}", r"\1", text).replace(
        "$NPROC", "8").replace("$TP", "1")
    words = shlex.split(text.split(" -m ", 1)[1].replace("\\\n", " "),
                        comments=True)
    words = words[:words.index("$@")]
    return words[0], words[1:]


@pytest.mark.parametrize("name", ["run_spacer_sg_rlvr.sh", "run_grpo_video.sh",
                                  "run_spacer_sft.sh", "run_aria_moe.sh",
                                  "run_eval.sh"])
def test_launch_scripts_parse(name):
    """spacer_tpu_torch/scripts/<name> passes the JAX script's flags, plus
    --multihost true, --tp (TP=, 1 by default) and, for the
    GRPO trainers, the global prompt count as rollout_batch_size, and its
    entry point parses them all."""
    import pathlib

    from spacer_tpu_torch.cli import evaluate, train_grpo, train_sft
    from spacer_tpu_torch.cli import train_sg_rlvr
    from spacer_tpu_torch.cli.common import ModelArgs
    from spacer_tpu_torch.evalharness import EvalConfig
    from spacer_tpu_torch.train.sft_trainer import SFTConfig
    from spacer_tpu_torch.train.trainer import SGRLVRConfig
    from spacer_tpu_torch.utils.config import parse_configs

    repo = pathlib.Path(__file__).resolve().parent.parent
    module, argv = _script_argv(repo / "spacer_tpu_torch" / "scripts" / name)
    jax_module, jax_argv = _script_argv(repo / "scripts" / name)
    assert module == jax_module.replace("spacer_tpu.", "spacer_tpu_torch.")
    flags = {w for w in argv if w.startswith("--")}
    jax_flags = {w for w in jax_argv if w.startswith("--")}
    assert flags - jax_flags <= {"--multihost", "--rollout_batch_size",
                                 "--tp"}
    assert jax_flags <= flags
    classes = {
        "spacer_tpu_torch.cli.train_sg_rlvr": (train_sg_rlvr.ScriptArgs,
                                               SGRLVRConfig, ModelArgs),
        "spacer_tpu_torch.cli.train_grpo": (train_grpo.ScriptArgs,
                                            SGRLVRConfig, ModelArgs),
        "spacer_tpu_torch.cli.train_sft": (train_sft.ScriptArgs, SFTConfig,
                                           ModelArgs),
        "spacer_tpu_torch.cli.evaluate": (EvalConfig, ModelArgs),
    }[module]
    parsed = parse_configs(classes, argv)
    assert parsed[-1].multihost is True
    # every script carries --tp (Aria's since its tp plan was ported)
    assert "--tp" in flags
    assert parsed[-1].tp == 1
    if "--rollout_batch_size" in flags:
        assert parsed[1].rollout_batch_size == 8


@pytest.mark.parametrize("world", [2, 4])
def test_accumulated_clipped_update_over_shards(collective_runs, world):
    """MultiSteps over fsdp blocks clips at the norm of the whole mean
    gradient (summed over the shards) and draws the int8 moments' dither
    as one process does: the update equals the unsharded one up to the
    norm's summation order (1e-6 absolute at learning rate 1e-2)."""
    want = _accumulated_update()
    for res in collective_runs[world]:
        np.testing.assert_allclose(res["multisteps"].numpy(), want.numpy(),
                                   rtol=0, atol=1e-6)
