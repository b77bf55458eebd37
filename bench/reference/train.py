"""The reference's training steps: the loss and gradients of the plain
model (``model.py``) sequence by sequence, then AdamW (Loshchilov &
Hutter, with Adam's bias corrections; no weight decay, no clipping), in
float32.  It follows the program's first steps from the same weights,
batches and seeds and reports what the check compares: each step's
loss, every leaf's first gradient norm, and every leaf's change after
the last step."""
from __future__ import annotations

from typing import Dict, List

import torch

from reference import model

B1, B2, EPS = 0.9, 0.999, 1e-8


def follow(conf: Dict, cell: Dict, params: Dict[str, torch.Tensor],
           batches: List[Dict[str, torch.Tensor]], state_seed: int,
           n_steps: int, precision: str = "f32") -> Dict:
    """``params`` ({path: f32 tensor}) are updated in place.  Returns
    {"losses": [...], "grad_norms": {path: ‖g₁‖}, "change_norms": {path:
    ‖p_n - p_0‖}, "head_grad": the output head's g₁, in host memory}."""
    arith = model.Arith(precision)
    head = "embed" if conf["tie_embeddings"] else "head"
    first = {n: x.clone() for n, x in params.items()}
    m = {n: torch.zeros_like(x) for n, x in params.items()}
    v = {n: torch.zeros_like(x) for n, x in params.items()}
    lr = cell["lr"]
    losses, grad_norms = [], {}
    for step in range(n_steps):
        batch = batches[step]
        rows = range(cell["batch"])
        n_total = cell["batch"] * cell["seq"]
        for x in params.values():
            x.requires_grad_(True)
            x.grad = None
        loss = 0.0
        for r in rows:
            seq = model.Seq(conf, cell, state_seed, step, r, batch[
                "tokens"].device)
            part = model.seq_loss(conf, params, batch["tokens"][r],
                                  batch["labels"][r], seq, arith, n_total)
            part.backward()
            loss += float(part.detach())
        losses.append(loss)
        with torch.no_grad():
            bc1, bc2 = 1.0 - B1 ** (step + 1), 1.0 - B2 ** (step + 1)
            for n, p in params.items():
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                if step == 0:
                    grad_norms[n] = float(torch.linalg.vector_norm(g))
                    if n == head:
                        head_grad = g.cpu()
                m[n].mul_(B1).add_(g, alpha=1 - B1)
                v[n].mul_(B2).addcmul_(g, g, value=1 - B2)
                p.requires_grad_(False)
                p.grad = None
                p.sub_(lr * (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + EPS))
    change = {n: float(torch.linalg.vector_norm(params[n] - first[n]))
              for n in params}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change, "head_grad": head_grad}
