"""The port's checkpoint format (``repro_torch.train.checkpoint``): leaves of
every dtype the train state holds round-trip bit for bit, staging and
retention behave as the reference's, the versioned run-state record
crosses between the two packages in both directions, and an asynchronous
save is a snapshot, not a view of the state the next step updates in
place."""
import json
import threading

import numpy as np
import pytest
import torch

from repro.train import checkpoint as jax_checkpoint
from repro_torch.api import DataSpec, Run, RunSpec
from repro_torch.core import WTACRSConfig
from repro_torch.launch import train_steps
from repro_torch.models import common as cm
from repro_torch.train import checkpoint, optim

torch.set_num_threads(1)


def _tree(seed=0):
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen)  # noqa: E731
    return {
        "bf16": r(3, 5).to(torch.bfloat16),
        "bf16_0d": r(()).to(torch.bfloat16),
        "bf16_strided": r(4, 6).to(torch.bfloat16)[:, ::2],
        "f16": r(2, 3).to(torch.float16),
        "f32_0d": r(()),
        "f32_transposed": r(3, 4).t(),
        "i32": torch.arange(5, dtype=torch.int32),
        "layers": [{"w": r(2, 2)}, {"w": r(2, 2)}],
        "opt": optim.AdamWState(3, {"w": r(2)}, {"w": r(2)}),
        "step": 7,
        "base_seed": 2 ** 62 + 5,
    }


def _bytes(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def _zeros_like(tree):
    return checkpoint._rebuild(
        tree, lambda _, x: torch.zeros_like(x)
        if isinstance(x, torch.Tensor) else 0)


def test_every_leaf_kind_round_trips_bit_exactly(tmp_path):
    tree = _tree()
    checkpoint.save(str(tmp_path), 3, tree)
    man = checkpoint.read_manifest(str(tmp_path))
    assert man["dtypes"]["bf16"] == "bfloat16"
    assert man["dtypes"]["f16"] == "float16"
    assert man["dtypes"]["opt/count"] == man["dtypes"]["step"] == "int64"
    assert "layers/1/w" in man["keys"] and "opt/m/w" in man["keys"]
    with np.load(tmp_path / "step_0000000003" / "arrays.npz") as data:
        # numpy has no bf16: a byte view, last dimension doubled
        assert data["bf16"].dtype == np.uint8
        assert data["bf16"].shape == (3, 10)
        assert data["bf16_0d"].shape == (2,)
        assert data["step"].dtype == np.int64 and data["step"].shape == ()
    template = _zeros_like(tree)
    out, step = checkpoint.restore(str(tmp_path), template)
    assert step == 3
    want, got = checkpoint._leaves(tree), checkpoint._leaves(out)
    assert [k for k, _ in want] == [k for k, _ in got]
    for (key, a), (_, b) in zip(want, got):
        if isinstance(a, int):
            assert type(b) is int and a == b, key
        else:
            assert b.dtype == a.dtype and b.shape == a.shape, key
            # bit for bit: compare the bytes, not the values
            assert torch.equal(_bytes(a), _bytes(b)), key
    # restored INTO the template: its tensors, refilled in place
    assert out["layers"][0]["w"] is template["layers"][0]["w"]
    assert isinstance(out["opt"], optim.AdamWState) and out["opt"].count == 3


def test_restore_refuses_a_shape_mismatch(tmp_path):
    checkpoint.save(str(tmp_path), 1, {"w": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(str(tmp_path), {"w": torch.zeros(3, 2)})


def test_staging_directory_is_ignored_and_keep_prunes(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4):
        checkpoint.save(d, s, {"x": torch.full((2,), float(s))}, keep=2)
    assert checkpoint.list_steps(d) == [3, 4]
    # a killed writer leaves only its staging directory behind
    (tmp_path / ".tmp-step_0000000009").mkdir()
    (tmp_path / "step_0000000010").mkdir()          # no manifest yet
    assert checkpoint.latest_step(d) == 4
    out, step = checkpoint.restore(d, {"x": torch.zeros(2)})
    assert step == 4 and out["x"].tolist() == [4.0, 4.0]
    assert checkpoint.latest_step(str(tmp_path / "nothing")) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.read_manifest(str(tmp_path / "nothing"))


@pytest.mark.parametrize("version", [99, 0, None])
def test_unknown_run_state_version_is_rejected(version):
    meta = checkpoint.pack_run_state({"version": 2, "budgets": {},
                                      "replans": 0, "trajectory": []})
    meta[checkpoint.RUN_STATE_KEY]["version"] = version
    with pytest.raises(ValueError, match="version"):
        checkpoint.unpack_run_state({"metadata": meta})
    assert checkpoint.unpack_run_state({"metadata": {}}) is None
    assert checkpoint.unpack_run_state({}) is None


def _schedule_json():
    return train_steps.ScheduleState(
        budgets={0: 0.4}, replans=1,
        trajectory=[{"step": 0, "rule": 0, "pattern": "*mlp*",
                     "budget": 0.3, "prev": None},
                    {"step": 2, "rule": 0, "pattern": "*mlp*",
                     "budget": 0.4, "prev": 0.3}]).to_json()


@pytest.mark.parametrize("writer,reader", [
    (jax_checkpoint, checkpoint), (checkpoint, jax_checkpoint)])
def test_run_state_record_crosses_between_the_packages(writer, reader,
                                                       tmp_path):
    assert checkpoint.RUN_STATE_KEY == jax_checkpoint.RUN_STATE_KEY
    assert checkpoint.RUN_STATE_VERSION == jax_checkpoint.RUN_STATE_VERSION
    meta = writer.pack_run_state(_schedule_json(), arch="qwen2.5-3b",
                                 optim_layouts=["adamw"],
                                 history=[{"step": 0, "loss": 1.5}])
    # through a manifest on disk, written by the other package's save
    if writer is checkpoint:
        writer.save(str(tmp_path), 2, {"x": torch.zeros(2)}, metadata=meta)
    else:
        writer.save(str(tmp_path), 2, {"x": np.zeros(2, np.float32)},
                    metadata=meta)
    rec = reader.unpack_run_state(reader.read_manifest(str(tmp_path)))
    assert rec == json.loads(json.dumps(meta[writer.RUN_STATE_KEY]))
    assert train_steps.ScheduleState.from_json(rec["schedule_state"]) \
        .to_json() == _schedule_json()


def test_v1_record_is_readable():
    meta = checkpoint.pack_run_state(_schedule_json())
    meta[checkpoint.RUN_STATE_KEY]["version"] = 1
    assert checkpoint.unpack_run_state({"metadata": meta})["version"] == 1


def test_async_save_is_a_snapshot_not_a_view(tmp_path, monkeypatch):
    """``save(block=False)`` then a step that updates the parameters, the
    moments and the cache in place: the checkpoint holds the state as it
    was at the save.  The disk write is held back until the step is done,
    so a snapshot that were a view of the live tensors would be caught."""
    pol = cm.Policy(wtacrs=WTACRSConfig(kind="wta_crs", budget=0.3,
                                        min_rows=2,
                                        norm_source="cached_grad"))
    spec = RunSpec(arch="qwen2.5-3b", policy=pol, steps=4, batch_size=4,
                   data=DataSpec(seq_len=16, n_samples=8),
                   checkpoint_dir=str(tmp_path))
    run = Run(spec, device="cpu")
    run.fit(steps=2)
    want = {k: v.copy() for k, v in checkpoint._flatten(run.state)[0].items()}
    gate, real_save = threading.Event(), checkpoint.save

    def gated_save(*args, **kw):
        assert gate.wait(60)
        return real_save(*args, **kw)

    monkeypatch.setattr(checkpoint, "save", gated_save)
    run.save(block=False)
    run.step(run.dataset.batch_at(2, spec.batch_size))
    moved = checkpoint._flatten(run.state)[0]
    assert not np.array_equal(moved["params/embed"], want["params/embed"])
    assert not np.array_equal(moved["opt/m/embed"], want["opt/m/embed"])
    gate.set()
    run._async_ckpt.wait()
    monkeypatch.setattr(checkpoint, "save", real_save)
    back = Run.restore(spec, device="cpu")
    assert int(back.state["step"]) == 2 and len(back.history) == 2
    got = checkpoint._flatten(back.state)[0]
    assert sorted(got) == sorted(want)
    for key in want:
        assert np.array_equal(got[key], want[key]), key


# ---------------------------------------------------------------------------
# optimizer-state layouts through the Run façade (the reference's
# tests/test_optim.py TestRunIntegration, on the port)
# ---------------------------------------------------------------------------

def _mixed_spec():
    from repro_torch import optim as optim_lib
    return optim_lib.OptimSpec.of(
        dict(pattern="unit/*/mlp/*", layout="lowrank", rank=6,
             refresh_every=3),
        dict(pattern="unit/*/attn/*", layout="lowrank",
             schedule=optim_lib.RankSchedule.linear(8, 4, begin_step=2,
                                                    end_step=8, stages=2)),
        dict(pattern="embed*", layout="factored", momentum=False))


def _optim_spec(tmp_path, optimizer, steps=8):
    return RunSpec(arch="minicpm-2b", steps=steps, batch_size=4,
                   optimizer=optimizer,
                   data=DataSpec(seq_len=16, n_samples=16),
                   checkpoint_dir=str(tmp_path / "ckpt"))


def _states_equal(a, b):
    fa, ta = checkpoint._flatten(a)
    fb, tb = checkpoint._flatten(b)
    return ta == tb and all(np.array_equal(fa[k], fb[k]) for k in fa)


@pytest.mark.parametrize("which", ["factored", "mixed_lowrank"])
def test_optim_spec_kill_resume_is_bit_faithful(tmp_path, which):
    from repro_torch import optim as optim_lib
    optimizer = (optim_lib.OptimSpec.of(dict(pattern="unit/*",
                                             layout="factored"))
                 if which == "factored" else _mixed_spec())
    run = Run(_optim_spec(tmp_path, optimizer), device="cpu")
    run.fit(steps=4)
    run.save()
    run.fit(steps=8)
    assert run.schedule_state.rank_trajectory or which == "factored"

    resumed = Run.resume(_optim_spec(tmp_path, optimizer), device="cpu")
    assert int(resumed.state["step"]) == 4
    assert "leaves" in resumed.state["opt"]
    resumed.fit(steps=8)
    assert _states_equal(run.state, resumed.state)
    assert resumed.schedule_state.ranks == run.schedule_state.ranks
    assert resumed.schedule_state.to_json() == run.schedule_state.to_json()
    assert checkpoint.unpack_run_state(checkpoint.read_manifest(
        str(tmp_path / "ckpt")))["optim_layouts"] == list(
            optimizer.layouts_used())


def test_legacy_adamw_checkpoint_restores_under_dense_spec(tmp_path):
    from repro_torch import optim as optim_lib
    legacy = Run(_optim_spec(tmp_path, optim.AdamWConfig()), device="cpu")
    legacy.fit(steps=4)
    legacy.save()
    legacy.fit(steps=8)

    resumed = Run.restore(_optim_spec(tmp_path, optim_lib.OptimSpec.from_adamw(
        optim.AdamWConfig())), device="cpu")
    assert "leaves" in resumed.state["opt"]       # converted format
    resumed.fit(steps=8)
    # the dense layout is the legacy AdamW bit for bit: the continuation
    # equals the uninterrupted legacy run
    assert _states_equal(legacy.state["params"], resumed.state["params"])


def test_legacy_checkpoint_rejects_compressed_spec(tmp_path):
    legacy = Run(_optim_spec(tmp_path, optim.AdamWConfig()), device="cpu")
    legacy.fit(steps=2)
    legacy.save()
    with pytest.raises(ValueError, match="legacy dense-AdamW"):
        Run.restore(_optim_spec(tmp_path, _mixed_spec()), device="cpu")


def test_new_checkpoint_rejects_adamw_config(tmp_path):
    run = Run(_optim_spec(tmp_path, _mixed_spec()), device="cpu")
    run.fit(steps=2)
    run.save()
    with pytest.raises(ValueError, match="OptimSpec.from_adamw"):
        Run.restore(_optim_spec(tmp_path, optim.AdamWConfig()),
                    device="cpu")


def test_unknown_layout_in_manifest_rejected(tmp_path):
    run = Run(_optim_spec(tmp_path, _mixed_spec()), device="cpu")
    run.fit(steps=2)
    run.save()
    mpath = tmp_path / "ckpt" / f"step_{2:010d}" / "manifest.json"
    manifest = json.loads(mpath.read_text())
    manifest["metadata"][checkpoint.RUN_STATE_KEY]["optim_layouts"] = [
        "blockdiag"]
    mpath.write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="blockdiag"):
        Run.restore(_optim_spec(tmp_path, _mixed_spec()), device="cpu")


def test_report_carries_optimizer_memory_section(tmp_path):
    run = Run(_optim_spec(tmp_path, _mixed_spec()), device="cpu")
    run.fit(steps=4)
    rep = run.report()
    assert "§Optimizer memory" in rep
    assert "x** reduction" in rep
    assert "| `unit/*/attn/*` |" in rep           # the rank trajectory
