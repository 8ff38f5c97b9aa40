"""Hierarchical ZeRO++ of the port, on the CPU: hpZ's secondary partition
(``zero_hpz_partition_size``), MiCS's sub-groups (``mics_shard_size``) and
two-level qgZ over a data axis factored into outer ``data`` × inner
``subdata`` (``parallel/topology.py`` ``factor_data_axis``).

The port trains in four spawned gloo CPU ranks (rank bodies in
``torch_zeropp_ranks.py``); the JAX engine runs on a ``{"data": 4}``
submesh of the conftest's CPU devices, factored by the same keys.

* ``factor_data_axis`` against the JAX function, its ``ValueError``
  included; the oracle's split dims and groups against the JAX oracle's
  ``PartitionSpec`` axes for each mode at stages 1-3 (gpt2-tiny shapes,
  an MLP width of 102 among them, which divides by the inner group and
  not by the world).
* Engines against the JAX engine at ``{"data": 4}``, gpt2-tiny at 2
  layers, three steps from the bridged weights: hpZ 2 at stage 3, MiCS 2
  at stages 2 and 3 (losses and grad norms within 1e-5, the params as
  ``test_torch_mesh_engine.py`` holds them), hpZ 2 with the qwZ int8
  gather (the qwZ tolerances of ``test_torch_zero_schedule.py``) and
  two-level qgZ at stage 1 under hpZ 2 (``test_torch_dp_compression.py``'s
  int8 bound on each leaf's update).
* The layout: under hpZ a stage-3 param holds 1/2 of its leaf and its
  master and Adam state 1/4, nested in the param slice (the world slice
  ``inner_rank · 2 + outer_rank``, on a leaf whose halves differ); under
  MiCS both hold 1/2; the weight gathers run over the inner group only,
  the stepped slices are gathered over the outer group only; MiCS's grad
  norm equals the unfactored run's within 1e-6.
* Checkpoints under hpZ and MiCS: pickle, fast and universal saves resume
  bit for bit; an hpZ checkpoint loads into plain ZeRO-3 at data 2; MiCS
  writes each slice once; the universal ``source_specs`` equal the JAX
  ``_source_specs`` of the same run.
"""

import jax
import numpy as np
import pytest

from deepspeed_tpu.checkpoint import universal as jun
from deepspeed_tpu.models import get_model_config as jax_model_config
from deepspeed_tpu.parallel import topology as jtopology
from deepspeed_tpu.resilience import oracle as joracle
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu_torch.checkpoint import universal as tun
from deepspeed_tpu_torch.launcher import launch
from deepspeed_tpu_torch.models import get_model_config
from deepspeed_tpu_torch.models import transformer as tf_model
from deepspeed_tpu_torch.models.bridge import params_from_jax
from deepspeed_tpu_torch.parallel import topology as ttopology
from deepspeed_tpu_torch.resilience.oracle import PartitionOracle
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

import torch_mesh_ranks
import torch_zeropp_ranks
from test_torch_dp_compression import INT8_UPDATE_RTOL
from test_torch_engine_v2 import one_torch_thread  # noqa: F401
from test_torch_mesh_engine import (CFG, LR, NO_GRADIENT, _batch, _check,
                                    _get, _jax_run, _paths)
from test_torch_zero_schedule import QWZ_RTOL

KW = {"num_layers": 2}
STEPS = 3
GAS = CFG["gradient_accumulation_steps"]
ROWS = CFG["train_micro_batch_size_per_gpu"] * GAS * 4


def _cfg(stage, **zc):
    return {**CFG, "mesh": {"data": 4},
            "zero_optimization": {"stage": stage,
                                  "param_persistence_threshold": 0, **zc}}


HPZ = {"zero_hpz_partition_size": 2}
MICS = {"mics_shard_size": 2}


# ----------------------------------------------------------------------
# the factored axis and the oracle
# ----------------------------------------------------------------------
@pytest.mark.parametrize("sizes,shard", [
    ({"data": 4}, 2), ({"data": 8}, 4), ({"data": 4, "seq": 2}, 4),
    ({"data": 2, "subdata": 2}, 4), ({"data": 4}, 1),
    ({"data": 4}, 3), ({"data": 6}, 4), ({"data": 4}, 0)])
def test_factor_data_axis_matches_jax(sizes, shard):
    try:
        want = jtopology.factor_data_axis(sizes, shard)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            ttopology.factor_data_axis(sizes, shard)
        return
    assert ttopology.factor_data_axis(sizes, shard) == want


def _jax_axes(entry):
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("mode", ["none", "hpz", "mics"])
def test_oracle_splits_match_the_jax_specs(mode, stage):
    """Every gpt2-tiny leaf (and one with an MLP width of 102), params and
    state: the port's ``split_for`` dim and the axes of its group equal
    the JAX oracle's ``PartitionSpec``."""
    sizes = {"data": 4} if mode == "none" else \
        jtopology.factor_data_axis({"data": 4}, 2)
    jtopo = jtopology.MeshTopology(sizes, devices=jax.devices()[:4])
    jor = joracle.PartitionOracle(jtopo, zero_stage=stage,
                                  secondary_mode=mode)
    mine = PartitionOracle(tun._SizesOnlyTopology(sizes), zero_stage=stage,
                           secondary_mode=mode)
    checked = 0
    for kw in ({}, {"intermediate_size": 102}):
        params = tf_model.init_params(get_model_config("gpt2-tiny", **KW,
                                                       **kw),
                                      seed=0, device="cpu")
        for path, x in _paths(params):
            name, shape = "/".join(path), tuple(x.shape)
            for style in (True, False):
                spec = tuple(jor.spec_for(name, shape, param_style=style))
                want = [(i, _jax_axes(e)) for i, e in enumerate(spec)
                        if e is not None]
                got = mine.split_for(name, shape, param_style=style)
                got = [] if got is None else [
                    (got[0], mine.fsdp_axes(style))]
                assert got == want, (name, style, got, want)
                if got:
                    assert mine.group_of(style) == (
                        "inner" if mode == "mics" or (mode == "hpz" and style)
                        else "world")
                checked += bool(want)
    assert checked


# ----------------------------------------------------------------------
# engines against the JAX engine
# ----------------------------------------------------------------------
ENGINES = {
    "hpz3": _cfg(3, **HPZ),
    "mics2": _cfg(2, **MICS),
    "mics3": _cfg(3, **MICS),
    "hpz3-qwz": _cfg(3, **HPZ, zero_quantized_weights=True),
    "qgz-hpz": _cfg(1, **HPZ, zero_quantized_gradients=True),
}


@pytest.mark.parametrize("name", list(ENGINES))
def test_hierarchical_engines_match_the_jax_engine(name):
    cfg = ENGINES[name]
    batch = _batch(ROWS)
    want = _jax_run(jax_model_config("gpt2-tiny", **KW), cfg, batch,
                    steps=STEPS)
    run = {"name": name, "model": "gpt2-tiny", "model_kw": KW, "cfg": cfg,
           "params": params_from_jax(want["p0"], get_model_config(
               "gpt2-tiny", **KW), device="cpu"),
           "batch": batch, "steps": STEPS}
    ranks = launch(torch_zeropp_ranks.hier_runs, 4, args=([run],),
                   backend="gloo", device="cpu")
    got = ranks[0][name]
    for r in ranks[1:]:
        assert r[name]["losses"] == got["losses"]
        assert r[name]["checksum"] == got["checksum"]
    if name == "qgz-hpz":
        # the JAX 1-bit step reports no grad norm: losses and the update
        assert got["onebit"] == "qgz"
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        assert got["losses"][-1] < got["losses"][0]
        for path, a in _paths(want["params"]):
            mine = _get(got["params"], path)
            if path not in NO_GRADIENT:
                update = a - _get(want["p0"], path)
                assert np.linalg.norm(mine - a) <= \
                    INT8_UPDATE_RTOL * np.linalg.norm(update), path
            assert np.abs(mine - a).max() <= LR, path
        # two levels: an all-to-all pair (payload, scales) in each group
        calls = got["steps"][-1]["calls"]
        assert calls["inner"]["all_to_all"] == calls["outer"]["all_to_all"] \
            == 2
        return
    rtol = (QWZ_RTOL + (QWZ_RTOL[-1],)) if name.endswith("qwz") else \
        (1e-5,) * STEPS
    _check(got, want, rtol=rtol)


def test_two_level_qgz_converges_like_the_jax_test():
    """The mirror of the JAX ``test_onebit.py::
    test_qgz_compressed_dp_gradients_converge`` (data 8 cut to 4): qgZ at
    ZeRO-1 under hpZ 2 on gpt2-tiny (2 layers, lr 1e-3, gas 1, 16 rows of
    16 tokens) converges over six steps and ends within 10 % of the exact
    AdamW run's loss; the two-level reduction runs each step (an
    all-to-all pair in the inner group and in the outer)."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 512, (16, 17)).astype(np.int32)
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:].copy()}
    base = {"train_micro_batch_size_per_gpu": 4,
            "gradient_accumulation_steps": 1,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
            "mesh": {"data": 4}, "steps_per_print": 10_000}
    runs = [{"name": name, "model": "gpt2-tiny", "model_kw": KW,
             "batch": batch, "steps": 6,
             "cfg": {**base, "zero_optimization": {"stage": 1, **zc}}}
            for name, zc in (("qgz", {"zero_quantized_gradients": True,
                                      **HPZ}), ("adamw", {}))]
    ranks = launch(torch_zeropp_ranks.hier_runs, 4, args=(runs,),
                   backend="gloo", device="cpu")
    qgz, ref = ranks[0]["qgz"], ranks[0]["adamw"]
    assert qgz["onebit"] == "qgz" and ref["onebit"] is None
    assert qgz["losses"][-1] < qgz["losses"][0]
    assert abs(qgz["losses"][-1] - ref["losses"][-1]) / ref["losses"][-1] \
        < 0.1
    for step in qgz["steps"]:
        assert step["calls"]["inner"]["all_to_all"] == \
            step["calls"]["outer"]["all_to_all"] == 2


# ----------------------------------------------------------------------
# the layout, the groups and MiCS's grad norm
# ----------------------------------------------------------------------
def test_layouts_groups_and_norms():
    batch = _batch(ROWS)
    params = tf_model.init_params(get_model_config("gpt2-tiny", **KW),
                                  seed=3, device="cpu")
    # copies: the launch moves the tensors into shared memory
    full = {"/".join(p): x.detach().numpy().copy()
            for p, x in _paths(params)}
    runs = [{"name": n, "model": "gpt2-tiny", "model_kw": KW, "cfg": c,
             "params": params, "batch": batch, "steps": 2}
            for n, c in (("plain3", _cfg(3)), ("hpz3", _cfg(3, **HPZ)),
                         ("mics3", _cfg(3, **MICS)),
                         ("mics2", _cfg(2, **MICS)), ("plain2", _cfg(2)))]
    ranks = launch(torch_zeropp_ranks.hier_runs, 4, args=(runs,),
                   backend="gloo", device="cpu")
    for r in ranks:
        rank, inner, outer, n_in, n_out = r["hpz3"]["place"]
        assert (n_in, n_out) == (2, 2)
        assert (inner, outer) == (rank % 2, rank // 2)
        nested = 0
        for path, lay in r["hpz3"]["layout"].items():
            f = lay["full"]
            d = next(i for i, (a, b) in enumerate(zip(lay["param"], f))
                     if a != b)
            assert lay["param"][d] * 2 == f[d], path
            assert lay["master"][d] * 4 == f[d] == lay["mu"][d] * 4, path
            # the master is the outer chunk of the param's inner chunk
            halves = np.split(full[path], 2, axis=d)
            want = np.split(halves[inner], 2, axis=d)[outer]
            np.testing.assert_array_equal(r["hpz3"]["masters0"][path], want)
            nested += not np.array_equal(halves[0], halves[1])
        # the weights' halves differ (the norms and biases start constant)
        assert nested == sum(x.std() > 0 for x in full.values()), nested
        for name in ("mics3", "mics2"):
            for path, lay in r[name]["layout"].items():
                f = lay["full"]
                d = next(i for i, (a, b) in enumerate(zip(lay["master"], f))
                         if a != b)
                assert lay["master"][d] * 2 == f[d] == lay["mu"][d] * 2
                assert lay["param"] == (lay["master"] if name == "mics3"
                                        else f), (name, path)
                np.testing.assert_array_equal(
                    r[name]["masters0"][path],
                    np.split(full[path], 2, axis=d)[inner])
    got = ranks[0]
    leaves = len(full)
    for step, plain in zip(got["hpz3"]["steps"], got["plain3"]["steps"]):
        calls = step["calls"]
        # the forward and backward weight gathers (plain ZeRO-3's world
        # gathers, as many) over the inner group only
        assert calls["inner"]["all_gather"] == \
            plain["calls"]["world"]["all_gather"]
        # the stepped slices, gathered over the outer group only
        assert calls["outer"]["all_gather"] == leaves
        assert {g for g, ops in calls.items() if "all_gather" in ops} == \
            {"inner", "outer"}
    for name in ("mics3", "mics2", "plain2"):
        assert got[name]["losses"] == pytest.approx(got["plain3"]["losses"],
                                                    rel=1e-6)
    np.testing.assert_allclose(got["mics3"]["grad_norms"],
                               got["plain3"]["grad_norms"], rtol=1e-6)
    np.testing.assert_allclose(got["mics2"]["grad_norms"],
                               got["plain2"]["grad_norms"], rtol=1e-6)
    np.testing.assert_allclose(got["hpz3"]["grad_norms"],
                               got["plain3"]["grad_norms"], rtol=1e-6)


# ----------------------------------------------------------------------
# checkpoints
# ----------------------------------------------------------------------
def _assert_state(got, want, what):
    assert sorted(got) == sorted(want), what
    for name, a in want.items():
        np.testing.assert_array_equal(got[name], a, err_msg=f"{what} {name}")


@pytest.mark.parametrize("mode", ["hpz", "mics"])
def test_hierarchical_checkpoints_resume_and_move(mode, tmp_path):
    """Four ranks save pickle, fast and universal forms and each resumes
    at the saving mesh with every saved leaf and the next losses bit for
    bit.  hpZ: the checkpoint loads into plain ZeRO-3 at data 2 (two
    ranks) with equal state, and the losses within 1e-5.  MiCS: the fast
    checkpoint writes each slice once (two pieces a split leaf, disjoint,
    covering it).  The universal ``source_specs`` are the JAX
    ``_source_specs`` of the same run."""
    cfg = _cfg(3, **(HPZ if mode == "hpz" else MICS))
    run = {"model": "gpt2-tiny", "model_kw": KW, "cfg": cfg,
           "params": tf_model.init_params(get_model_config("gpt2-tiny",
                                                           **KW),
                                          seed=3, device="cpu"),
           "batch": _batch(ROWS, seed=9), "steps": 2,
           "ckpt": str(tmp_path / mode)}
    ranks = launch(torch_zeropp_ranks.ckpt_runs, 4, args=(run,),
                   backend="gloo", device="cpu")
    saved, after = ranks[0]["saved"], ranks[0]["after"]
    assert any(".mu/" in name for name in saved)
    for r in ranks:
        assert r["after"] == after
        for form, res in r["resumed"].items():
            assert res["global_steps"] == 2 and res["losses"] == after, form
    for form, res in ranks[0]["resumed"].items():
        _assert_state(res["state"], saved, f"{mode} {form}")
    meta = ranks[0]["universal_meta"]
    manifest = {k: tuple(v) for k, v in meta["param_manifest"].items()}
    assert meta["source_specs"] == jun._source_specs(
        meta["source_mesh"], meta["ds_config"], manifest)
    assert meta["source_mesh"]["subdata"] == 2
    if mode == "hpz":
        plain = {**run, "cfg": {**_cfg(3), "mesh": {"data": 2},
                                "train_micro_batch_size_per_gpu": 4}}
        two = launch(torch_mesh_ranks.resume_forms, 2, args=(plain,),
                     backend="gloo", device="cpu")
        for form, res in two[0].items():
            _assert_state(res["state"], saved, f"hpz->data2 {form}")
            np.testing.assert_allclose(res["losses"], after, rtol=1e-5)
        return
    pieces = {}
    for index in ranks[0]["shard_index"].values():
        for info in index.values():
            pieces.setdefault(info["leaf"], []).append(info)
    assert pieces
    for leaf, infos in pieces.items():
        assert len(infos) == 2, leaf
        shape = infos[0]["shape"]
        cover = np.zeros(shape, np.int32)
        for info in infos:
            cover[tuple(slice(a, b) for a, b in info["slices"])] += 1
        assert (cover == 1).all(), leaf


# ----------------------------------------------------------------------
# the keys
# ----------------------------------------------------------------------
@pytest.mark.parametrize("zc,logged", [
    ({"stage": 3, "zero_hpz_partition_size": 2}, None),
    ({"stage": 3, "mics_shard_size": 2,
      "mics_hierarchical_params_gather": True},
     "mics_hierarchical_params_gather"),
    ({"stage": 3, "zero_quantized_nontrainable_weights": True},
     "zero_quantized_nontrainable_weights"),
    ({"stage": 1, "zero_quantized_gradients": True,
      "zero_hpz_partition_size": 2}, None),
], ids=["hpz", "mics", "nontrainable", "qgz"])
def test_hierarchical_keys_are_read_as_jax_reads_them(zc, logged,
                                                      monkeypatch):
    from deepspeed_tpu_torch.runtime import config as tconfig

    seen = []
    monkeypatch.setattr(tconfig.logger, "warning",
                        lambda msg, *a, **k: seen.append(str(msg)))
    cfg = {"train_micro_batch_size_per_gpu": 1, "zero_optimization": zc}
    mine, theirs = DeepSpeedConfig(cfg), JaxConfig(cfg)
    for key in ("zero_hpz_partition_size", "mics_shard_size",
                "zero_quantized_nontrainable_weights",
                "mics_hierarchical_params_gather"):
        assert getattr(mine.zero_config, key) == \
            getattr(theirs.zero_config, key), key
    assert joracle.secondary_mode_from_config(theirs.zero_config) == \
        PartitionOracle.from_config(tun._SizesOnlyTopology({}),
                                    mine).secondary_mode
    assert any(logged in w and "ignored" in w for w in seen) \
        if logged is not None else not seen
