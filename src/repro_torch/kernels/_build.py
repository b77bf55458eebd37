"""Build and bind the CUDA kernels: nvcc by hand, a plain C interface, ctypes.

The sources under ``csrc/`` are compiled for ``sm_90a`` into one shared
library the first time a kernel is launched — never at import, so the
package imports (and its CPU tests run) on a machine with neither
``nvcc`` nor a card.  Each ``.cu`` is compiled by its own ``nvcc``
process, all started together, and the objects are linked into
``librepro_torch_kernels.so`` under a directory keyed by a hash of the
sources and flags: an edit rebuilds, an unchanged tree reuses.

The library goes to ``$REPRO_TORCH_BUILD_DIR`` when that is set, else to
``build/repro_torch_kernels/`` beside ``src/`` (git-ignored).

There is no fallback here: a missing compiler or a failed compile raises,
and the kernel wrappers let that propagate.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of the C interface (csrc/common.cuh: enum DType).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point -> argtypes.  Every pointer and the stream are c_void_p:
# left undeclared, ctypes would pass them as 32-bit ints and cut them.
_SIGNATURES = {
    "repro_row_norms": (_P, _P, _I, _I, _I, _P),
    "repro_fused_sampled_dw": (_P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "repro_flash_attention_fwd": (_P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "repro_gather_scale": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "repro_sampled_matmul": (_P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _I, _P),
}


def build_root() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    root = Path(__file__).resolve().parents[3]
    return root / "build" / "repro_torch_kernels"


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, /usr/local/cuda "
        "and PATH); the repro_torch kernels are built from source at first "
        "use and need the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if this source hash was not built yet) and return the
    library's path.  ``build.log`` beside it keeps nvcc's output,
    including each kernel's registers/shared memory/spills."""
    out_dir = build_root() / _source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    # Build in a private directory and rename into place, so two processes
    # building at once never load a half-written library.
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, objs = [], []
        for src, obj, cmd, proc in procs:
            text, _ = proc.communicate()
            log.append("$ " + " ".join(cmd) + "\n" + text)
            if proc.returncode != 0:
                for _, _, _, other in procs:
                    if other.poll() is None:
                        other.kill()
                        other.wait()
                raise RuntimeError(
                    f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                    f"{text}")
            objs.append(str(obj))
        tmp_lib = Path(tmp) / LIB_NAME
        link = [nvcc, "-shared", "-o", str(tmp_lib), *objs]
        done = subprocess.run(link, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        log.append("$ " + " ".join(link) + "\n" + done.stdout)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{done.stdout}")
        (out_dir / "build.log").write_text("\n".join(log))
        os.replace(tmp_lib, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), argtypes set."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def aligned16(*tensors: torch.Tensor) -> bool:
    """Whether every tensor's data starts on a 16-byte boundary (what TMA
    and 16-byte vector loads need)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def check_launch(code: int, what: str) -> None:
    """Raise if a C entry point reported a refused launch."""
    if code != 0:
        raise RuntimeError(
            f"{what}: kernel launch failed with code {code} "
            f"(negative: rejected argument; positive: cudaError_t)")


def check_operand(name: str, t: torch.Tensor, dtype=None, shape=None,
                  device=None) -> None:
    """The checks every wrapper makes on each operand, on any device,
    before a pointer is handed out."""
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (strides "
                         f"{t.stride()}); call .contiguous() first")
