"""Serve a model (PyTorch/CUDA port): continuous batching through the
slot-pool session.

    PYTHONPATH=src python examples/torch_serve_decode.py --requests 6 \
        --prompt-len 12 --gen 16 [--device cuda]

Exercises the serving path end to end: ``ServeSpec`` fixes the pool
geometry (and rejects unservable archs — e.g. ``--arch whisper-base`` —
at construction, with the reason, before any device work),
``Run.serve()`` opens a :class:`repro_torch.serve.ServeSession` on the
run's params, and the async host loop admits a burst of ragged requests
into the paged cache pool, interleaving chunked prefill with batched
decode.  Finishes by printing the session's §Serving report.  The default
arch is qwen2.5-3b (the JAX example's default, zamba2-2.7b, needs the
Mamba blocks, which are not ported yet).
"""
import argparse
import time

import numpy as np

from repro_torch.api import Run, RunSpec, ServeSpec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    # construction-time validation: unknown arch, enc-dec, or impossible
    # geometry all fail HERE, not hundreds of steps into a live service
    spec = ServeSpec(arch=args.arch, reduced=not args.full_size,
                     max_slots=args.slots, page_size=args.page_size,
                     max_len=args.prompt_len + args.gen,
                     prefill_chunk=args.prefill_chunk,
                     top_k=8 if args.temperature > 0 else 0,
                     device=args.device)

    # no init(): the serving methods draw the parameters alone, without
    # the optimizer moments a train state would allocate beside them
    run = Run(RunSpec(arch=args.arch, reduced=not args.full_size, seed=0),
              device=args.device)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, run.cfg.vocab_size,
                            size=rng.integers(2, args.prompt_len + 1))
               for _ in range(args.requests)]
    gens = [int(rng.integers(max(1, args.gen // 2), args.gen + 1))
            for _ in range(args.requests)]

    t0 = time.perf_counter()
    with run.serve(spec).start() as sess:
        handles = [sess.submit(p, max_new=g,
                               temperature=args.temperature, seed=0)
                   for p, g in zip(prompts, gens)]
        for i, h in enumerate(handles):
            toks = h.result(timeout=600)
            print(f"req {i}: prompt[{len(prompts[i])}] -> "
                  f"{len(toks)} tokens: {toks[:12]}"
                  + (" ..." if len(toks) > 12 else ""))
        dt = time.perf_counter() - t0
        n_tok = sum(gens)
        print(f"\nserved {args.requests} ragged requests / {n_tok} "
              f"tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s)\n")
        print(sess.report())


if __name__ == "__main__":
    main()
