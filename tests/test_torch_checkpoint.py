"""The port's checkpoints (``deepspeed_tpu_torch/checkpoint/``, ``io/``)
against the JAX package's, on the CPU.

Universal checkpoints cross both ways: the JAX engine's (gpt2-tiny,
``"mesh": {"data": 1}``, three steps) loads into the port and the port's
into the JAX engine, and the two continue the same two steps within the
tolerance ``test_torch_train_engine.py`` holds the engines to (fp32:
losses 1e-5 relative, params 1e-5 (1 + |p|) but the key bias, whose
gradient is zero up to rounding); both packages' universal dirs of one
state have the same files and ``meta.json`` keys, ``zero_to_fp32`` gives
the JAX file's arrays, and each package reads the other's tensor file.
The port's own round trips (pickle, fast, decoupled, universal) continue
bit for bit at stage 0, at ZeRO-3 over two gloo ranks (resumed at data 2
bit for bit, at data 1 within 1e-5 relative: another summation order),
and over a seq axis of two (the ring).  The decoupled snapshot is taken
when ``save`` returns, and a mismatched checkpoint raises before it
changes anything.
"""

import json
import os
import pickle
import shutil

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu as dsj
import deepspeed_tpu_torch as dst
from deepspeed_tpu.checkpoint import universal as jun
from deepspeed_tpu.io import fast_file_writer as jio
from deepspeed_tpu.models import get_model_config as jax_model_config
from deepspeed_tpu.parallel import topology as jtopology
from deepspeed_tpu_torch.checkpoint import universal as tun
from deepspeed_tpu_torch.checkpoint.fast_engine import DecoupledCheckpointEngine
from deepspeed_tpu_torch.io import fast_file_writer as tio
from deepspeed_tpu_torch.launcher import launch
from deepspeed_tpu_torch.models import get_model_config
from deepspeed_tpu_torch.models.bridge import params_from_jax, params_to_numpy
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

import torch_checkpoint_ranks
from test_torch_engine_v2 import one_torch_thread  # noqa: F401

CFG = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
       "optimizer": {"type": "AdamW", "params": {"lr": 2e-3,
                                                 "weight_decay": 0.1}},
       "scheduler": {"type": "WarmupLR",
                     "params": {"warmup_min_lr": 1e-4, "warmup_max_lr": 2e-3,
                                "warmup_num_steps": 3}},
       "gradient_clipping": 1.0, "steps_per_print": 10_000,
       "activation_checkpointing": {"remat_policy": "none"}}
NO_GRADIENT = ("layers", "attn", "bk")


def _batch(rows, seed=2, seq=32):
    ids = np.random.default_rng(seed).integers(0, 512, (rows, seq + 1)).astype(np.int32)
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:].copy()}


BATCH = _batch(4)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _jax_engine(seed=3, **over):
    jtopology.set_topology(None)
    eng, *_ = dsj.initialize(model=jax_model_config("gpt2-tiny"),
                             config={**CFG, "mesh": {"data": 1}, **over},
                             seed=seed)
    return eng


def _port_engine(params=None, seed=3, **over):
    eng, *_ = dst.initialize(model=get_model_config("gpt2-tiny"),
                             config={**CFG, **over}, device="cpu",
                             model_parameters=params, seed=seed)
    return eng


def _losses(eng, n, jax_side=False):
    if jax_side:
        return [float(np.asarray(eng.train_batch(BATCH))) for _ in range(n)]
    return [float(eng.train_batch(BATCH)) for _ in range(n)]


def _assert_parity(port_losses, jax_losses, port_eng, jax_eng):
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-5)
    pj = jax.tree.map(np.asarray, jax_eng.params)
    pt = params_to_numpy(port_eng.params)
    for path, a in _paths(pj):
        if path != NO_GRADIENT:
            assert np.all(np.abs(_get(pt, path) - a) <= 1e-5 * (1 + np.abs(a))), path


@pytest.fixture(scope="module")
def universal_pair(tmp_path_factory):
    """One state in both packages: the JAX engine and the port (from the
    JAX init) each train three steps, save and convert to universal."""
    root = tmp_path_factory.mktemp("pair")
    jeng = _jax_engine()
    p0 = jax.tree.map(np.asarray, jeng.params)
    _losses(jeng, 3, jax_side=True)
    jeng.save_checkpoint(str(root / "jax"), tag="t3")
    judir = jun.ds_to_universal(str(root / "jax"), tag="t3")
    jtopology.set_topology(None)
    teng = _port_engine(params_from_jax(p0, get_model_config("gpt2-tiny"),
                                        device="cpu"))
    _losses(teng, 3)
    teng.save_checkpoint(str(root / "port"), tag="t3")
    tudir = tun.ds_to_universal(str(root / "port"), tag="t3")
    return {"root": root, "jax": judir, "port": tudir}


def test_port_resumes_a_jax_universal_checkpoint(universal_pair):
    """The JAX engine's universal checkpoint loads into the port
    (``load_universal_checkpoint``), and the port's next two steps are the
    JAX engine's from the same checkpoint."""
    jeng = _jax_engine(seed=11, load_universal_checkpoint=True)
    jeng.load_checkpoint(universal_pair["jax"])
    teng = _port_engine(seed=12, load_universal_checkpoint=True)
    teng.load_checkpoint(universal_pair["jax"])
    assert teng.global_steps == 3 and int(teng.opt_state["count"]) == 3
    assert teng.lr_scheduler.state_dict() == jeng.lr_scheduler.state_dict()
    want = _losses(jeng, 2, jax_side=True)
    _assert_parity(_losses(teng, 2), want, teng, jeng)
    jtopology.set_topology(None)


def test_jax_resumes_a_port_universal_checkpoint(universal_pair):
    """The reverse: the port's universal checkpoint loads into the JAX
    engine, which continues as the port does."""
    teng = _port_engine(seed=12)
    tun.load_universal(teng, universal_pair["port"])
    got = _losses(teng, 2)
    jeng = _jax_engine(seed=11, load_universal_checkpoint=True)
    jeng.load_checkpoint(universal_pair["port"])
    assert jeng.global_steps == 3
    _assert_parity(got, _losses(jeng, 2, jax_side=True), teng, jeng)
    jtopology.set_topology(None)


def test_lion_state_crosses_by_the_chain_names(tmp_path):
    """Lion's state (the optax chain's ``0/.count``, ``0/.mu``) crosses
    too: the JAX engine's universal checkpoint resumes in the port, and
    the next step agrees."""
    lion = {"optimizer": {"type": "Lion", "params": {"lr": 1e-3,
                                                     "weight_decay": 0.1}}}
    jeng = _jax_engine(**lion)
    _losses(jeng, 2, jax_side=True)
    jeng.save_checkpoint(str(tmp_path), tag="l")
    udir = jun.ds_to_universal(str(tmp_path), tag="l")
    assert sorted(os.listdir(os.path.join(udir, "optimizer")))[:2] == [
        "0__.count.npy", "0__.mu__embed__positions.npy"]
    want = _losses(jeng, 1, jax_side=True)
    teng = _port_engine(seed=12, **lion)
    tun.load_universal(teng, udir)
    assert int(teng.opt_state["count"]) == 2 and "nu" not in teng.opt_state
    _assert_parity(_losses(teng, 1), want, teng, jeng)
    jtopology.set_topology(None)


def test_universal_dirs_have_the_same_files_and_meta(universal_pair):
    """Same file names (params/<path>.npy, optimizer/0__.mu__<path>.npy,
    the marker) and meta.json keys; the step counters, scheduler, loss
    scale, manifest, dtypes and source specs equal; every array within
    the engines' tolerance."""
    def files(d):
        return sorted(os.path.relpath(os.path.join(r, f), d)
                      for r, _, fs in os.walk(d) for f in fs)

    jd, td = universal_pair["jax"], universal_pair["port"]
    assert files(jd) == files(td)
    assert "optimizer/0__.count.npy" in files(td)
    assert "optimizer/0__.nu__layers__mlp__wi.npy" in files(td)
    with open(os.path.join(jd, "meta.json")) as f:
        jm = json.load(f)
    with open(os.path.join(td, "meta.json")) as f:
        tm = json.load(f)
    assert sorted(jm) == sorted(tm)
    for key in ("global_steps", "micro_steps", "lr_scheduler",
                "loss_scale_state", "param_manifest", "param_dtypes",
                "opt_treedef_leaves", "source_mesh", "source_specs"):
        assert jm[key] == tm[key], key
    for name in files(jd):
        if name.endswith(".npy"):
            a, b = np.load(os.path.join(jd, name)), np.load(os.path.join(td, name))
            assert a.dtype == b.dtype and a.shape == b.shape, name
            if "bk" not in name:
                assert np.all(np.abs(b - a) <= 1e-4 * (1 + np.abs(a))), name


def test_zero_to_fp32_matches_jax(universal_pair):
    root = universal_pair["root"]
    jout = jun.zero_to_fp32(str(root / "jax"), str(root / "j.pkl"), tag="t3")
    tout = tun.zero_to_fp32(str(root / "port"), str(root / "t.pkl"))
    with open(jout, "rb") as f:
        jflat = pickle.load(f)
    with open(tout, "rb") as f:
        tflat = pickle.load(f)
    assert sorted(jflat) == sorted(tflat)
    for k, a in jflat.items():
        assert tflat[k].dtype == np.float32 and tflat[k].shape == a.shape
        if "bk" not in k:
            assert np.all(np.abs(tflat[k] - a) <= 1e-5 * (1 + np.abs(a))), k


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tensor_files_read_across_packages(tmp_path, writer):
    """The byte format is the JAX package's: a file written by either
    package (several flushes of a small buffer, a 0-d entry) reads in the
    other, whole and entry by entry."""
    tensors = {"a/w": np.random.default_rng(0).standard_normal((33, 7)).astype(np.float32),
               "b": np.arange(10, dtype=np.int32), "c": np.asarray(7, np.int32)}
    path = str(tmp_path / "t.bin")
    write = jio.write_tensor_file if writer == "jax" else tio.write_tensor_file
    reader = tio if writer == "jax" else jio
    stats = write(path, tensors, buffer_bytes=64)
    assert stats["flush_count"] >= 10
    out = reader.read_tensor_file(path)
    assert set(out) == set(tensors)
    index, base = reader.read_tensor_index(path)
    for k, v in tensors.items():
        np.testing.assert_array_equal(out[k].reshape(v.shape), v)
        assert out[k].dtype == v.dtype
        np.testing.assert_array_equal(
            reader.read_tensor_entry(path, base, index[k]).reshape(v.shape), v)


def test_file_writers(tmp_path):
    """The double buffer cycles and lands every byte; the py and mock
    writers count; the AIO path is not ported and says so."""
    payload = np.random.default_rng(0).integers(0, 255, 10_000, dtype=np.uint8)
    w = tio.FastFileWriter(str(tmp_path / "out.bin"), buffer_bytes=1024)
    w.write(payload.tobytes())
    stats = w.close()
    assert stats == {"bytes_written": 10_000, "flush_count": 10}
    assert (tmp_path / "out.bin").read_bytes() == payload.tobytes()
    arr = np.arange(100, dtype=np.float32)
    p = tio.PyFileWriter(str(tmp_path / "py.bin"))
    p.write_array(arr)
    assert p.close()["bytes_written"] == arr.nbytes
    m = tio.MockFileWriter(str(tmp_path / "mock.bin"))
    m.write_array(arr)
    assert m.close()["bytes_written"] == arr.nbytes
    assert not (tmp_path / "mock.bin").exists()
    with pytest.raises(NotImplementedError, match="Queue A item 7"):
        tio.FastFileWriter(str(tmp_path / "aio.bin"), use_aio=True)


@pytest.mark.parametrize("form", ["pickle", "fast", "decoupled", "universal"])
def test_round_trip_continues_bit_for_bit(tmp_path, form):
    """Stage 0: save after two steps, train two more; a fresh engine of
    another seed loads the save and takes the same two steps bit for
    bit, ending on the same params, optimizer state and scheduler."""
    writer = {"pickle": "", "universal": ""}.get(form, form)
    over = {"checkpoint": {"writer": {"type": writer}}}
    eng = _port_engine(seed=1, **over)
    _losses(eng, 2)
    eng.save_checkpoint(str(tmp_path), tag="t")
    if form == "decoupled":
        eng.checkpoint_engine.wait()
    if form == "universal":
        tun.ds_to_universal(str(tmp_path))
    assert (tmp_path / "latest").read_text() == "t"
    want = _losses(eng, 2)
    eng2 = _port_engine(seed=9, load_universal_checkpoint=form == "universal",
                        **over)
    eng2.load_checkpoint(str(tmp_path))
    assert eng2.global_steps == 2 and eng2.micro_steps == 4
    assert _losses(eng2, 2) == want
    assert eng2.lr_scheduler.state_dict() == eng.lr_scheduler.state_dict()
    for key in ("mu", "nu"):
        for a, b in zip(_flat(eng.opt_state[key]), _flat(eng2.opt_state[key])):
            assert torch.equal(a, b)
    for a, b in zip(_flat(eng.params), _flat(eng2.params)):
        assert torch.equal(a, b)


def _flat(tree):
    return [leaf for _p, leaf in _paths(tree)]


def test_zero3_saved_at_data2_resumes_at_data2_and_data1(tmp_path):
    """ZeRO-3 over two gloo ranks: the pickle save gathers every slice,
    the fast save writes each rank's slices with their bounds.  Each form
    (and the universal conversion) resumes at data 2 bit for bit, and at
    data 1 in this process within 1e-5 relative."""
    cfg = {**CFG, "mesh": {"data": 2},
           "zero_optimization": {"stage": 3, "param_persistence_threshold": 0}}
    jeng = _jax_engine()
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params),
                             get_model_config("gpt2-tiny"), device="cpu")
    jtopology.set_topology(None)
    batch = _batch(8)
    run = {"model": "gpt2-tiny", "params": params, "cfg": cfg,
           "batch": batch, "steps": 2, "ckpt": str(tmp_path)}
    ranks = launch(torch_checkpoint_ranks.save_and_resume, 2, args=(run,),
                   backend="gloo", device="cpu")
    after = ranks[0]["after"]
    assert ranks[1]["after"] == after
    for r in ranks:
        for form, losses in r["resumed"].items():
            assert losses == after, form
    assert sorted(os.listdir(tmp_path / "fast")) == [
        "meta.json", "model_states_p000.bin", "model_states_p001.bin",
        "shard_index_p000.json", "shard_index_p001.json"]
    one = {**cfg, "mesh": {"data": 1}, "train_micro_batch_size_per_gpu": 4}
    for form in ("pickle", "fast", "universal"):
        eng, *_ = dst.initialize(model=get_model_config("gpt2-tiny"),
                                 config=one, device="cpu", seed=99)
        if form == "universal":
            tun.load_universal(eng, str(tmp_path / "pickle" / "universal"))
        elif form == "fast":
            from deepspeed_tpu_torch.checkpoint.fast_engine import \
                FastCheckpointEngine

            FastCheckpointEngine().load(eng, str(tmp_path), "fast")
        else:
            eng.load_checkpoint(str(tmp_path), tag="pickle")
        got = [float(eng.train_batch(batch)) for _ in range(2)]
        np.testing.assert_allclose(got, after, rtol=1e-5, err_msg=form)


def test_ring_seq2_resumes_bit_for_bit(tmp_path):
    """Over a seq axis of two (llama-tiny's ring attention, striped) the
    state is whole on both ranks: rank 0 writes, and each form resumes at
    seq 2 bit for bit."""
    run = {"model": "llama-tiny", "model_kw": {"seq_impl": "ring"},
           "params": None, "cfg": {**CFG, "mesh": {"seq": 2}},
           "batch": BATCH, "steps": 2, "ckpt": str(tmp_path)}
    ranks = launch(torch_checkpoint_ranks.save_and_resume, 2, args=(run,),
                   backend="gloo", device="cpu")
    for r in ranks:
        assert r["after"] == ranks[0]["after"]
        for form, losses in r["resumed"].items():
            assert losses == ranks[0]["after"], form


def test_decoupled_snapshot_isolated(tmp_path):
    """Decoupled save must snapshot: the fused AdamW steps the params in
    place after save() returns and before wait(), and what lands on disk
    is the params at save()."""
    eng = _port_engine(seed=1, optimizer={"type": "AdamW",
                                          "params": {"lr": 1e-1}})
    ce = DecoupledCheckpointEngine()
    first = eng.params["embed"]["tokens"]
    before = first.detach().clone()
    ce.save(eng, str(tmp_path), "snap")
    assert ce.last_save_blocked_s > 0
    eng.train_batch(BATCH)
    ce.wait()
    saved = tio.read_tensor_file(str(tmp_path / "snap" / "model_states.bin"),
                                 names=["module/embed/tokens"])
    np.testing.assert_array_equal(saved["module/embed/tokens"], before.numpy())
    assert (first.detach() - before).abs().max() > 0


@pytest.mark.parametrize("model_kw,float_count,err", [
    ({"hidden_size": 64, "num_heads": 2}, False, "shape mismatch"),
    ({}, True, "dtype mismatch"),
], ids=["shape", "dtype"])
def test_universal_mismatch_raises_before_any_change(universal_pair, tmp_path,
                                                     model_kw, float_count,
                                                     err):
    """A checkpoint of another shape (or a float step count where the
    optimizer keeps an int32 one) raises, and the engine keeps its params
    and counters: the mirror of the JAX ``test_universal_shape_mismatch_
    raises``."""
    udir = universal_pair["port"]
    if float_count:
        udir = str(tmp_path / "u")
        shutil.copytree(universal_pair["port"], udir)
        np.save(os.path.join(udir, "optimizer", "0__.count.npy"),
                np.asarray(3.5, np.float32))
    eng, *_ = dst.initialize(model=get_model_config("gpt2-tiny", **model_kw),
                             config=CFG, device="cpu", seed=1)
    before = [t.detach().clone() for t in _flat(eng.params)]
    with pytest.raises(ValueError, match=err):
        tun.load_universal(eng, udir)
    assert all(torch.equal(a, b) for a, b in zip(before, _flat(eng.params)))
    assert eng.global_steps == 0 and int(eng.opt_state["count"]) == 0


def test_checkpoint_config_keys():
    """``checkpoint.writer.type`` "", "fast" and "decoupled" run; the JAX
    package's orbax engine (``"orbax"``, ``async_save``) raises;
    ``load_universal`` and the top-level ``load_universal_checkpoint``
    set the universal load; an unknown writer is refused."""
    base = {"train_micro_batch_size_per_gpu": 1}
    for t in ("", "fast", "decoupled"):
        c = DeepSpeedConfig({**base, "checkpoint": {"writer": {"type": t}}})
        assert c.checkpoint_config.writer_type == t
        assert not c.load_universal_checkpoint
    assert DeepSpeedConfig({**base, "checkpoint": {"load_universal": True}}
                           ).load_universal_checkpoint
    assert DeepSpeedConfig({**base, "load_universal_checkpoint": True}
                           ).load_universal_checkpoint
    for block in ({"writer": {"type": "orbax"}}, {"async_save": True}):
        with pytest.raises(NotImplementedError, match="orbax"):
            DeepSpeedConfig({**base, "checkpoint": block})
    with pytest.raises(Exception, match="writer.type"):
        DeepSpeedConfig({**base, "checkpoint": {"writer": {"type": "tape"}}})


def test_checkpoint_engine_follows_the_writer_config(tmp_path):
    """The engine's ``checkpoint_engine`` is the writer the config names
    (the pickle engine for ""), and a writer named anew replaces it once
    the last one's write has landed: a decoupled save then a pickle save
    both commit."""
    from deepspeed_tpu_torch.checkpoint.engine import PickleCheckpointEngine

    eng = _port_engine(seed=1, checkpoint={"writer": {"type": "decoupled"}})
    dec = eng.checkpoint_engine
    assert isinstance(dec, DecoupledCheckpointEngine)
    assert eng.checkpoint_engine is dec
    eng.save_checkpoint(str(tmp_path), tag="dec")
    eng.config.checkpoint_config.writer_type = ""
    assert isinstance(eng.checkpoint_engine, PickleCheckpointEngine)
    assert dec._worker is None       # waited for before it was replaced
    assert (tmp_path / "dec" / "model_states.bin").exists()
    eng.save_checkpoint(str(tmp_path), tag="pkl")
    assert (tmp_path / "pkl" / "mp_rank_00_model_states.pt").exists()
    assert (tmp_path / "latest").read_text() == "pkl"


def test_failed_save_raises(tmp_path):
    """A save that cannot write raises; ``latest`` does not move."""
    eng = _port_engine(seed=1)
    blocker = tmp_path / "t"
    blocker.write_text("a file where the tag dir should go")
    with pytest.raises(OSError):
        eng.save_checkpoint(str(tmp_path), tag="t")
    assert not (tmp_path / "latest").exists()
