"""The Run session: a live training/serving session built from a RunSpec.

One object owns everything the hand-wired path spread over eight call
sites: tag enumeration, state init (cache + stats sized from the
policy), the scheduled step and its step-function cache, controller band
state, checkpointing with a versioned run-state record, the serve path,
and reporting.  Algorithm 1 becomes::

    run = Run(RunSpec(arch="qwen2.5-3b", policy=policy, steps=200,
                      checkpoint_dir="ck", checkpoint_every=25))
    run.fit()                      # or: run.step(batch) per batch
    print(run.report())

Kill it anywhere and ``Run.resume(spec)`` continues bit-faithfully:
params, optimizer, znorm cache, budget statistics AND the scheduled
step's controller band positions all come back (the band state rides the
checkpoint manifest as a versioned record).

Every step maker runs on ``device`` (``"cuda"`` unless the caller asks for
the CPU); on the card the sampled linears go through the hand-written
kernels.

``RunSpec(mesh="host")`` runs data parallel: every rank of the
initialised process group builds the same Run, draws the same parameters
from the seed (checked with each leaf's all-gathered sha256), trains on
its slice of each global batch through the data-parallel scheduled step,
restores from the same checkpoints; rank 0 alone writes checkpoints
(after a barrier) and prints ``fit``'s log lines.  With
``model_parallel`` M above 1 the ranks form a (W / M, M) mesh: each
draws the whole parameters from the seed and keeps its shards of them
and of the optimizer state (``train_steps.shard_train_state``), the
ranks of a model group train on the same batch slice, and the
replication check runs over the data group.  A checkpoint holds the
whole state (``train_steps.gather_train_state``: a one-rank
checkpoint's keys, shapes and dtypes), written by the global rank 0
alone (data index 0, model index 0), and ``restore`` shards what it
reads, so a checkpoint moves between model-parallel widths.  ``prefill``
/ ``decode`` / ``generate`` / ``serve`` run on the shards, each model
group serving its batch whole (the caches split as
``launch.sharding.serving_state_specs`` says).

``Run.dryrun`` traces one rank of this run's (arch, policy) on a
production mesh cell (``launch/dryrun.py``) and keeps the record for
``report``'s §Roofline.
"""
from __future__ import annotations

import hashlib
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import optim as optim_lib
from repro_torch.api.spec import RunSpec, ServeSpec
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import report as report_lib
from repro_torch.launch import sharding as shard_lib
from repro_torch.launch import train_steps
from repro_torch.models import registry
from repro_torch.serve import ServeSession, sampling
from repro_torch.train import checkpoint, znorm
from repro_torch.train import optim as adamw_lib


class Run:
    """A training/serving session.  See module docstring.

    Attributes of note: ``state`` (the train-state dict), ``history``
    (per-step float metrics), ``step_fn`` (the scheduled step —
    ``step_fn.compiled`` / ``.replans`` / ``.budget_trajectory`` expose
    the re-plan economy), ``tags`` (the znorm-cache tag list, empty when
    the policy needs no cache).
    """

    def __init__(self, spec: RunSpec, device="cuda"):
        self.spec = spec
        self.device = resolve_device(device)
        self.cfg = get_config(spec.arch, reduced=spec.reduced)
        # one kernel decision for the whole run: RunSpec.kernel maps over
        # every config the policy can resolve to
        self.policy = (spec.policy if spec.kernel is None
                       else spec.policy.with_kernel(spec.kernel))
        self.use_znorm_cache = spec.use_znorm_cache
        self.track_budget_stats = spec.track_budget_stats
        self.dataset = spec.data.build(self.cfg)
        self.tags: List[str] = (
            znorm.collect_linear_tags(self.cfg, policy=self.policy)
            if self.use_znorm_cache else [])
        self.mesh = (mesh_lib.make_host_mesh(spec.model_parallel,
                                             device=self.device)
                     if spec.mesh == "host" else None)
        if self.mesh is None and spec.model_parallel != 1:
            raise ValueError(f"model_parallel={spec.model_parallel} needs "
                             f"mesh='host'")
        self._model_parallel = (self.mesh is not None
                                and self.mesh.shape["model"] > 1)
        self._dryrun_rec: Optional[dict] = None
        self._world = 1 if self.mesh is None else self.mesh.shape["data"]
        self._rank = 0 if self.mesh is None else mesh_lib.data_index(
            self.mesh)
        # the global rank 0 writes checkpoints and prints
        self._lead = self._rank == 0 and (self.mesh is None or
                                          mesh_lib.model_index(self.mesh)
                                          == 0)
        if spec.batch_size % (self._world * spec.microbatches):
            raise ValueError(
                f"batch_size {spec.batch_size} does not split into "
                f"{self._world} ranks of {spec.microbatches} microbatches")
        self.state: Optional[Dict[str, Any]] = None
        # parameters drawn for serving before any train state exists
        self._params: Optional[Dict[str, Any]] = None
        self.history: List[dict] = []
        self.schedule_state = train_steps.ScheduleState()
        self._step_fn: Optional[train_steps.ScheduledStepFn] = None
        self._serve_fn = None
        self._prefill_fns: Dict[int, Any] = {}
        self._async_ckpt: Optional[checkpoint.AsyncCheckpointer] = None

    # ------------------------------------------------------------------
    # state lifecycle
    # ------------------------------------------------------------------

    def init(self) -> "Run":
        """Allocate the train state (idempotent); parameters already drawn
        for serving become its parameters."""
        if self.state is None:
            self.state = self._new_state(self.spec.optimizer)
        return self

    def _check_replicated(self, params) -> None:
        """Fail unless every rank holds the same parameter bits: each
        leaf's sha256, all-gathered and compared with this rank's."""
        paths, digests = [], []
        for path, p in adamw_lib.named_leaves(params):
            raw = p.detach().contiguous().reshape(-1).view(torch.uint8)
            paths.append(path)
            digests.append(np.frombuffer(
                hashlib.sha256(raw.cpu().numpy()).digest(), dtype=np.int64))
        mine = torch.from_numpy(np.stack(digests)).to(self.device)
        every = [torch.empty_like(mine) for _ in range(self._world)]
        dist.all_gather(every, mine, group=self.mesh.group)
        for other in every:
            if not torch.equal(other, mine):
                leaf = int((other != mine).any(dim=1).nonzero()[0])
                raise RuntimeError(
                    f"rank {self._rank}: the ranks drew different "
                    f"parameters from seed {self.spec.seed} (first at "
                    f"{paths[leaf]})")

    def _new_state(self, opt, whole: bool = False):
        """A fresh train state whose optimizer state has ``opt``'s layout
        (``restore`` of a legacy checkpoint asks for ``AdamWConfig``): on
        a model-parallel mesh this rank's shards of it, or the whole
        state with ``whole`` (the template a checkpoint is read into)."""
        params = self._params
        if self._model_parallel and params is not None:
            # parameters drawn for serving are this rank's shards
            params = shard_lib.gather_params(params, self._param_specs(),
                                             self.mesh)
        state = train_steps.init_train_state(
            self.cfg, self.spec.seed,
            znorm_tags=self.tags if self.use_znorm_cache else None,
            n_dataset=self.spec.data.n_samples,
            budget_stats=self.track_budget_stats, device=self.device,
            params=params, opt=opt,
            opt_ranks=self.schedule_state.ranks or None)
        self._params = None
        if self._model_parallel and not whole:
            state = self._shard(state)
        if self._world > 1 and not whole:
            self._check_replicated(state["params"])
        return state

    def _state_shardings(self, state):
        """``train_state_shardings`` of a (whole or sharded) train state
        of this run on its mesh."""
        whole, axes = train_steps.abstract_train_state(
            self.cfg, znorm_tags=self.tags if self.use_znorm_cache else None,
            n_dataset=self.spec.data.n_samples,
            budget_stats=self.track_budget_stats,
            opt=(None if isinstance(state["opt"], adamw_lib.AdamWState)
                 else self.spec.optimizer),
            opt_ranks=self.schedule_state.ranks or None)
        return train_steps.train_state_shardings(self.cfg, whole, axes,
                                                 self.mesh)

    def _shard(self, state):
        """This rank's shards of a whole train state."""
        return train_steps.shard_train_state(
            state, self._state_shardings(state), self.mesh)

    def _gather(self, state):
        """The whole train state from the model group's shards."""
        return train_steps.gather_train_state(
            state, self._state_shardings(state), self.mesh)

    def _param_specs(self):
        """{leaf path: spec} of the parameters on this run's mesh."""
        return train_steps.model_param_specs(self.cfg, self.mesh)

    def gathered_params(self) -> Dict[str, Any]:
        """The whole parameters: on a model-parallel mesh, every rank's
        shards all-gathered (``launch.sharding.gather_params``)."""
        if not self._model_parallel:
            return self.params
        return shard_lib.gather_params(self.params, self._param_specs(),
                                       self.mesh)

    @property
    def params(self) -> Dict[str, Any]:
        """The parameters the serving methods read: the train state's, or,
        before one exists, parameters alone from ``spec.seed`` (serving a
        fresh run allocates no optimizer moments, znorm cache or
        statistics); on a model-parallel mesh, this rank's shards."""
        if self.state is not None:
            return self.state["params"]
        if self._params is None:
            self._params = registry.init_params(self.cfg, self.spec.seed,
                                                device=self.device)
            if self._model_parallel:
                self._params = shard_lib.shard_params(
                    self._params, self._param_specs(), self.mesh)
        return self._params

    @property
    def step_fn(self) -> train_steps.ScheduledStepFn:
        """The scheduled step (built on first use, shared by every
        ``step``/``fit`` call so the step-function cache and controller
        band state persist)."""
        if self._step_fn is None:
            self._step_fn = train_steps.make_scheduled_train_step(
                self.cfg, self.policy, self.spec.optimizer,
                self.spec.make_lr_schedule(),
                schedule_state=self.schedule_state,
                use_znorm_cache=self.use_znorm_cache,
                microbatches=self.spec.microbatches, device=self.device,
                mesh=self.mesh,
                data_axes=self.spec.data_axes if self.mesh else None)
        return self._step_fn

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def step(self, batch) -> Dict[str, float]:
        """One optimizer step on one batch (dict of arrays; a
        ``sample_ids`` entry is consumed by the znorm cache and dropped
        automatically when the policy needs none).  On a host mesh
        ``batch`` is the global batch; each rank trains on its slice."""
        self.init()
        b = dict(batch)
        if self.mesh is not None:
            b = shard_lib.shard_batch(b, self.mesh)
        if not self.use_znorm_cache:
            b.pop("sample_ids", None)
        elif "sample_ids" not in b:
            raise ValueError(
                "this run's policy needs the znorm cache, so every "
                "batch must carry 'sample_ids' (dataset sample indices; "
                "DataSpec-built datasets provide them)")
        s = int(self.state["step"])
        self.state, metrics = self.step_fn(self.state, b)
        m = {k: float(v) for k, v in metrics.items()}
        self.history.append({"step": s, **m})
        return m

    def fit(self, dataset=None, steps: Optional[int] = None,
            log_every: int = 0) -> List[dict]:
        """Train from the state's current step to ``steps`` (default
        ``spec.steps``), checkpointing every ``spec.checkpoint_every``
        steps.  ``dataset`` overrides the spec-built corpus; it must
        expose ``batch_at(step, batch_size)`` (stateless step-indexed
        batches are what make kill/resume replay exact)."""
        self.init()
        ds = dataset if dataset is not None else self.dataset
        if (dataset is not None and self.use_znorm_cache
                and getattr(ds, "n_samples", None) is not None
                and ds.n_samples > self.spec.data.n_samples):
            raise ValueError(
                f"override dataset has {ds.n_samples} samples but the "
                f"znorm cache was sized to spec.data.n_samples "
                f"= {self.spec.data.n_samples}; out-of-range sample_ids "
                f"would silently clamp onto the last cache column.  Set "
                f"DataSpec(n_samples=...) to cover the dataset.")
        total = self.spec.steps if steps is None else steps
        start = int(self.state["step"])
        t0 = time.perf_counter()
        for s in range(start, total):
            m = self.step(ds.batch_at(s, self.spec.batch_size))
            if (log_every and self._lead
                    and (s % log_every == 0 or s == total - 1)):
                dt = (time.perf_counter() - t0) / max(s - start + 1, 1)
                print(f"step {s:5d}  loss {m['loss']:.4f}  "
                      f"lr {m['lr']:.2e}  {dt * 1e3:.0f} ms/step")
            if (self.spec.checkpoint_every
                    and (s + 1) % self.spec.checkpoint_every == 0):
                self.save(block=False)
        if self._async_ckpt is not None:
            self._async_ckpt.wait()
        self._barrier()
        return self.history

    def _barrier(self) -> None:
        """Every rank of the mesh (its data group's barrier, then its
        model group's)."""
        if self._world > 1:
            dist.barrier(group=self.mesh.group)
        if self._model_parallel:
            dist.barrier(group=self.mesh.model_group)

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------

    def _run_state_metadata(self) -> dict:
        # snapshot history: the async checkpointer serializes on a
        # worker thread while fit() keeps appending to the live list
        opt = self.spec.optimizer
        layouts = (list(opt.layouts_used())
                   if isinstance(opt, optim_lib.OptimSpec) else ["adamw"])
        return checkpoint.pack_run_state(
            self.schedule_state.to_json(),
            arch=self.spec.arch,
            optim_layouts=layouts,
            history=[dict(h) for h in self.history])

    def save(self, block: bool = True) -> None:
        """Checkpoint state + the versioned run-state record (controller
        band positions, trajectory, metrics history).  ``block=False``
        copies the state to host memory now and overlaps the disk write
        with the following steps.  On a host mesh every rank calls it and
        the global rank 0 writes, after a barrier (a blocking save passes a
        second one once the checkpoint is on disk); on a model-parallel
        mesh every rank first takes part in gathering the whole state
        (``train_steps.gather_train_state``, synchronously, also for
        ``block=False``)."""
        if not self.spec.checkpoint_dir:
            raise ValueError("RunSpec.checkpoint_dir is not set")
        self.init()
        step = int(self.state["step"])
        self._barrier()
        tree = (self._gather(self.state) if self._model_parallel
                else self.state)
        if not self._lead:
            del tree
            if block:
                self._barrier()
            return
        if block:
            if self._async_ckpt is not None:
                self._async_ckpt.wait()
            checkpoint.save(self.spec.checkpoint_dir, step, tree,
                            metadata=self._run_state_metadata(),
                            keep=self.spec.checkpoint_keep)
            self._barrier()
        else:
            if self._async_ckpt is None:
                self._async_ckpt = checkpoint.AsyncCheckpointer(
                    self.spec.checkpoint_dir,
                    keep=self.spec.checkpoint_keep)
            self._async_ckpt.save(step, tree,
                                  metadata=self._run_state_metadata())

    @classmethod
    def restore(cls, spec: RunSpec, step: Optional[int] = None,
                device="cuda") -> "Run":
        """Rebuild a Run from its latest (or given-step) checkpoint:
        params, optimizer, znorm cache, budget statistics, metrics
        history AND the scheduled step's controller band state — the
        budget trajectory continues instead of resetting to every
        controller's ``initial_budget``.  The state is allocated once on
        ``device`` and filled in place from the checkpoint.

        Optimizer-state compatibility: the manifest records which layouts
        wrote the checkpoint.  A legacy dense-AdamW checkpoint restores
        under an all-dense ``OptimSpec`` (converted in place); any other
        mismatch — unknown layout names, a factored/low-rank spec against
        a dense checkpoint or the other way round — fails with the
        reference's errors.  On a model-parallel mesh the whole state is
        read and this rank keeps its shards of it (a checkpoint written
        at any model-parallel width restores at any other)."""
        if not spec.checkpoint_dir:
            raise ValueError("RunSpec.checkpoint_dir is not set")
        run = cls(spec, device=device)
        if step is None:
            step = checkpoint.latest_step(spec.checkpoint_dir)
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints under {spec.checkpoint_dir}")
        manifest = checkpoint.read_manifest(spec.checkpoint_dir, step)
        rec = checkpoint.unpack_run_state(manifest)
        if rec is not None:
            if "schedule_state" in rec:
                run.schedule_state = train_steps.ScheduleState.from_json(
                    rec["schedule_state"])
            run.history = [dict(h) for h in rec.get("history", [])]
            unknown = [l for l in rec.get("optim_layouts", [])
                       if l not in optim_lib.KNOWN_LAYOUTS + ("adamw",)]
            if unknown:
                raise ValueError(
                    f"checkpoint step {step} was written with unknown "
                    f"optimizer-state layout(s) {unknown}; this reader "
                    f"knows {sorted(optim_lib.KNOWN_LAYOUTS)} (plus "
                    f"legacy 'adamw').  Upgrade repro to restore it.")
        # dense-AdamW checkpoints key their moments as opt/m/...; the
        # layout state keys opt/leaves/<path>/<slot> ("opt/count" exists
        # in both, so it cannot discriminate)
        keys = manifest.get("keys", ())
        legacy_ckpt = (any(k.startswith(("opt/m/", "opt/v/")) for k in keys)
                       and not any(k.startswith("opt/leaves/")
                                   for k in keys))
        spec_opt = spec.optimizer
        if legacy_ckpt and isinstance(spec_opt, optim_lib.OptimSpec):
            if not spec_opt.all_dense:
                raise ValueError(
                    f"checkpoint step {step} holds legacy dense-AdamW "
                    f"optimizer state but the spec's OptimSpec resolves "
                    f"to {spec_opt.layouts_used()}; factored/low-rank "
                    f"moments cannot be reconstructed from dense ones. "
                    f"Restore with an all-dense spec (or AdamWConfig) "
                    f"and switch layouts on a fresh run.")
            run.state, _ = checkpoint.restore(
                spec.checkpoint_dir,
                run._new_state(adamw_lib.AdamWConfig(), whole=True),
                step=step)
            run.state["opt"] = optim_lib.from_legacy_adamw(
                run.state["opt"], run.state["params"])
            run._adopt(run.state)
        elif not legacy_ckpt and not isinstance(spec_opt,
                                                optim_lib.OptimSpec):
            raise ValueError(
                f"checkpoint step {step} was written by an OptimSpec "
                f"(path-keyed optimizer state) but the spec carries a "
                f"legacy AdamWConfig; restore with "
                f"OptimSpec.from_adamw(cfg) to keep the layouts.")
        else:
            run.state, _ = checkpoint.restore(
                spec.checkpoint_dir, run._new_state(spec_opt, whole=True),
                step=step)
            run._adopt(run.state)
        return run

    def _adopt(self, whole) -> None:
        """A restored whole state becomes this rank's: its shards on a
        model-parallel mesh, checked across the data group."""
        if self._model_parallel:
            self.state = self._shard(whole)
        if self._world > 1:
            self._check_replicated(self.state["params"])

    @classmethod
    def resume(cls, spec: RunSpec, step: Optional[int] = None,
               device="cuda") -> "Run":
        """``restore`` when a checkpoint exists, else a fresh Run — the
        crash-rerun-the-same-command entry point."""
        if (spec.checkpoint_dir
                and checkpoint.latest_step(spec.checkpoint_dir)
                is not None):
            return cls.restore(spec, step=step, device=device)
        return cls(spec, device=device)

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------

    @property
    def _model_mesh(self):
        return self.mesh if self._model_parallel else None

    def _serve(self):
        if self._serve_fn is None:
            self._serve_fn = train_steps.make_serve_step(
                self.cfg, self.policy, device=self.device,
                mesh=self._model_mesh)
        return self._serve_fn

    def _prefill_chunk_fn(self, chunk_len: int):
        fn = self._prefill_fns.get(chunk_len)
        if fn is None:
            fn = train_steps.make_prefill_chunk_step(
                self.cfg, self.policy, chunk_len, device=self.device,
                mesh=self._model_mesh)
            self._prefill_fns[chunk_len] = fn
        return fn

    def _decode_states(self, batch_size: int, max_len: int):
        """Empty decode caches of ``max_len`` positions for ``batch_size``
        rows: on a model-parallel mesh this rank's shards of them
        (``launch.sharding.serving_state_specs``)."""
        states = registry.decode_state_init(self.cfg, batch_size, max_len,
                                            device=self.device)
        if not self._model_parallel:
            return states
        specs = shard_lib.serving_state_specs(self.cfg, states, self.mesh,
                                              batch_size)
        return shard_lib.shard_tree(states, specs, self.mesh)

    def prefill(self, prompts, gen: int = 0):
        """Stream a (B, S) prompt batch into decode caches with ``S + gen``
        token headroom, ``spec.prefill_chunk`` tokens per
        ``make_prefill_chunk_step`` call (decode steps, token by token:
        the numerics of decode itself, not the flash kernel).  Returns
        ``(last_token, pos, states)`` ready for :meth:`decode`; on a
        model-parallel mesh the states are this rank's shards."""
        params = self.params
        prompts = np.asarray(prompts, np.int64)
        b, s = prompts.shape
        states = self._decode_states(b, s + gen)
        t, chunk = 0, self.spec.prefill_chunk
        while t < s - 1:
            n = min(chunk, s - 1 - t)
            states = self._prefill_chunk_fn(n)(
                params, prompts[:, t:t + n], t, states)
            t += n
        return prompts[:, -1], s - 1, states

    def decode(self, token, pos, states):
        """One greedy decode step: ``(next_token, logits, states)`` (the
        logits whole on every rank of a model group)."""
        return self._serve()(self.params, token, pos, states)

    def generate(self, prompts, gen: int, temperature: float = 0.0,
                 seed: int = 0, top_k: int = 0) -> torch.Tensor:
        """Continuation: (B, S) prompts -> (B, gen) int32 token ids on the
        run's device.

        ``temperature == 0`` (default) is greedy argmax; > 0 samples,
        optionally ``top_k``-truncated, deterministically under a fixed
        ``seed``.  Randomness is keyed per (seed, row, step) through
        ``repro_torch.serve.sampling``, the same keying the slot-pool
        service uses with the batch row as request uid."""
        tok, pos, states = self.prefill(prompts, gen=gen)
        b = tok.shape[0]
        base = [sampling.request_key(seed, r) for r in range(b)]
        temp = np.full((b,), temperature, np.float32)
        out = []
        for g, t in enumerate(range(pos, pos + gen)):
            _, logits, states = self.decode(tok, t, states)
            tok = sampling.sample_logits(
                logits, sampling.step_keys(base, [g] * b), temp,
                top_k=top_k)
            out.append(tok)
        return torch.stack(out, dim=1)

    def serve(self, spec: Optional[ServeSpec] = None, **overrides):
        """Open a continuous-batching :class:`~repro_torch.serve.ServeSession`
        on this run's params.

        ``spec``: a full :class:`ServeSpec`; or pass field overrides
        (``max_slots=8, page_size=16, ...``) and one is built on this
        run's (arch, reduced, policy, prefill_chunk, device).  Start the
        async loop and submit::

            with run.serve(max_slots=4).start() as sess:
                tokens = sess.submit(prompt, max_new=16).result(60)

        On a model-parallel mesh every rank of a model group opens the
        session on its shards and submits the same requests
        (``serve/session.py``)."""
        if spec is None:
            overrides.setdefault("arch", self.spec.arch)
            overrides.setdefault("reduced", self.spec.reduced)
            overrides.setdefault("policy", self.policy)
            overrides.setdefault("prefill_chunk", self.spec.prefill_chunk)
            overrides.setdefault("device", str(self.device))
            spec = ServeSpec(**overrides)
        elif overrides:
            raise ValueError("pass either a ServeSpec or field "
                             "overrides, not both")
        return ServeSession(spec, self.params, policy=self.policy,
                            mesh=self._model_mesh)

    # ------------------------------------------------------------------
    # analysis
    # ------------------------------------------------------------------

    def dryrun(self, shape: str = "train_4k", mesh: str = "single") -> dict:
        """Trace one rank of this run's (arch, policy) on a production
        mesh cell (``launch.dryrun.lower_cell`` on the ``meta`` device) and
        keep the record for :meth:`report`.  The run's own config is
        traced: a ``reduced`` run's cell is the reduced arch's."""
        from repro_torch.launch.dryrun import lower_cell
        rec, _, _ = lower_cell(self.spec.arch, shape, mesh == "multi",
                               policy=self.policy,
                               microbatches=(self.spec.microbatches
                                             if self.spec.microbatches > 1
                                             else None),
                               cfg=self.cfg)
        self._dryrun_rec = rec
        return rec

    def report(self) -> str:
        """Markdown report: §Run metrics summary, §Budgets controller
        trajectory + re-plan economy, §Optimizer memory (OptimSpec
        runs), §Roofline (when ``dryrun`` ran)."""
        n_steps = int(self.state["step"]) if self.state is not None else 0
        n_compiles = (len(self._step_fn.compiled)
                      if self._step_fn is not None else 0)
        optim_rec = None
        if isinstance(self.spec.optimizer, optim_lib.OptimSpec):
            params = registry.init_params(self.cfg, 0, device="meta")
            optim_rec = optim_lib.memory_report(
                self.spec.optimizer, params,
                ranks=self.schedule_state.ranks or None)
        return report_lib.run_report(
            n_steps=n_steps,
            budget_records=self.schedule_state.trajectory,
            n_compiles=n_compiles, history=self.history,
            roofline_rec=self._dryrun_rec, optim_rec=optim_rec,
            rank_records=self.schedule_state.rank_trajectory)
