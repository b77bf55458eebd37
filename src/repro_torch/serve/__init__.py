"""Continuous-batching serving: slot-based paged cache pool + scheduler.

Public surface::

    from repro_torch.serve import ServeSpec, ServeSession

    spec = ServeSpec(arch="qwen2.5-3b", reduced=False, max_slots=8,
                     page_size=16, max_len=256)          # device="cuda"
    with ServeSession(spec, params).start() as sess:
        h = sess.submit([3, 14, 15], max_new=16)
        tokens = h.result(timeout=60)

Layers: ``spec`` (frozen geometry + construction-time validation),
``pool`` (paged KV + page free list), ``sampling``
(batch-composition-independent sampled decode), ``scheduler``
(admission / prefill-decode interleave / eviction), ``session`` (the
async host loop).  ``launch.train_steps`` builds the steps.
"""
from repro_torch.serve.scheduler import Request, Scheduler, Status
from repro_torch.serve.session import RequestHandle, ServeSession
from repro_torch.serve.spec import ServeSpec

__all__ = ["Request", "RequestHandle", "Scheduler", "ServeSession",
           "ServeSpec", "Status"]
