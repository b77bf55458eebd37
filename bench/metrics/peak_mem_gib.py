"""The card's peak allocated memory over set-up, warm-up and window
(``torch.cuda.max_memory_allocated``, read before the check allocates
anything), in GiB."""


def read(rec):
    return rec["peak_bytes"] / 2 ** 30 if rec["peak_bytes"] else None
