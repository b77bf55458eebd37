"""`repro_torch.api` — the declarative façade over the WTA-CRS trainer.

:class:`RunSpec` describes a run (arch, policy, optimizer, schedule,
data, checkpoint/microbatch options); :class:`Run` executes it on a
device — deriving the znorm-cache and budget-stats wiring from the
policy, owning the scheduled step and the controller band state, and
checkpointing ALL of it so kill/resume is bit-faithful.

    from repro_torch.api import Run, RunSpec

    run = Run.resume(RunSpec(arch="qwen2.5-3b", policy=policy,
                             steps=40, checkpoint_dir="ck",
                             checkpoint_every=10))      # device="cuda"
    run.fit(log_every=5)
    print(run.report())

The low-level parts (``launch.train_steps``, ``train.znorm``,
``train.checkpoint``) stay public; the façade only composes them.
"""
from repro_torch.api.run import Run
from repro_torch.api.spec import DataSpec, RunSpec, ServeSpec

__all__ = ["DataSpec", "Run", "RunSpec", "ServeSpec"]
