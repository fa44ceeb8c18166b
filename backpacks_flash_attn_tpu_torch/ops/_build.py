"""Build, load and count the port's hand-written CUDA kernels.

Every kernel lives in ``csrc/<name>.cu`` with a plain C entry point. It is
compiled with ``nvcc`` for ``sm_90a`` into ``build/torch_kernels/`` at the
root of the checkout (a directory ``.gitignore`` lists) on first CUDA use,
rebuilt whenever its source or the shared header changes, and loaded with
``ctypes``. Nothing here runs at import time: the CPU tests import every
module on machines with no ``nvcc`` and no card.

Each :class:`Kernel` carries a ``launches`` counter that its wrapper bumps
once per launch, so a run can show that the main path went through the
kernel. Each wrapper takes its kernel's plain PyTorch version for CPU
tensors, and for CUDA tensors only inside :func:`plain_path`, the one switch
(a comparison run opts into it explicitly); otherwise a CUDA tensor launches
the kernel or raises. The model code always calls the wrappers.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# dtype codes shared with csrc/common.cuh
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel: its source, the TPU kernel it replaces, its
    launch count and (once built) its loaded library."""
    name: str
    source: str
    replaces: str
    launches: int = 0
    build_log: str = ""
    lib: Optional[ctypes.CDLL] = dataclasses.field(default=None, repr=False)

    def library_path(self) -> Path:
        h = hashlib.sha256()
        for part in (CSRC / "common.cuh", CSRC / self.source):
            h.update(part.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}_{h.hexdigest()[:16]}.so"


KERNELS: Dict[str, Kernel] = {k.name: k for k in (
    Kernel("decode_attention", "decode_attention.cu",
           "backpacks_flash_attn_tpu/ops/decode_attention.py:77"),
    Kernel("quant_matmul", "quant_matmul.cu",
           "backpacks_flash_attn_tpu/ops/quant.py:161"),
    Kernel("flash_attention", "flash_attention.cu",
           "backpacks_flash_attn_tpu/ops/flash_attention.py:298"),
    Kernel("fused_contextualization", "fused_contextualization.cu",
           "backpacks_flash_attn_tpu/ops/backpack_kernels.py:281"),
)}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def build_all(names: Optional[List[str]] = None) -> float:
    """Compile every kernel whose library is missing, one ``nvcc`` per
    source, all started together. Returns the wall seconds it took; raises
    with the compiler's output if any build fails."""
    t0 = time.perf_counter()
    todo = [KERNELS[n] for n in (names or list(KERNELS))]
    missing = [k for k in todo if not k.library_path().exists()]
    if missing:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for k in missing:
            out = k.library_path()
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / k.source)]
            procs.append((k, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for k, out, tmp, proc in procs:
            log, _ = proc.communicate()
            k.build_log = log
            if proc.returncode != 0:
                failed.append(f"{k.source}:\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    for k in todo:
        load(k)
    return time.perf_counter() - t0


def load(kernel: Kernel) -> ctypes.CDLL:
    if kernel.lib is None:
        path = kernel.library_path()
        if not path.exists():
            build_all([kernel.name])
        kernel.lib = ctypes.CDLL(str(path))
        kernel.lib.kernel_error_string.argtypes = [ctypes.c_int]
        kernel.lib.kernel_error_string.restype = ctypes.c_char_p
    return kernel.lib


def launch(kernel: Kernel, symbol: str, *args) -> None:
    """Call the C entry ``symbol`` of ``kernel`` on the current stream (the
    stream is appended as the last argument); raise on a non-zero
    ``cudaGetLastError()``; count the launch."""
    lib = load(kernel)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = [_ctype(a) for a in args] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*args, stream)
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{kernel.name}: CUDA error {rc} ({msg})")
    kernel.launches += 1


def _ctype(arg):
    """Pointers travel as ``Ptr`` (c_void_p), floats as c_float, ints as
    c_longlong (the C entries take ``long long`` for every size/stride)."""
    if isinstance(arg, Ptr):
        return ctypes.c_void_p
    if isinstance(arg, float):
        return ctypes.c_float
    return ctypes.c_longlong


class Ptr(ctypes.c_void_p):
    """A device pointer argument (``Ptr.of(tensor)``; None -> NULL)."""

    @classmethod
    def of(cls, t: Optional[torch.Tensor]) -> "Ptr":
        return cls(None if t is None else t.data_ptr())


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


# ------------------------------------------------------------ path switch

_PLAIN = contextvars.ContextVar("backpacks_torch_plain_path", default=False)


def kernels_enabled() -> bool:
    """False inside :func:`plain_path`: the kernel wrappers then run their
    plain PyTorch versions, on whatever device the tensors are."""
    return not _PLAIN.get()


@contextlib.contextmanager
def plain_path() -> Iterator[None]:
    """Send every kernel wrapper called in this block to its plain PyTorch
    version (the comparison path of ``chip_smoke.py`` and the recompute
    oracle)."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


# ------------------------------------------------------------ devices

def resolve_device(device) -> torch.device:
    """The device an entry point allocates on. CUDA is the default of every
    entry point; asking for it on a machine without a card raises instead of
    running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def check_cuda_tensor(name: str, t: torch.Tensor, dtypes, ndim: int) -> None:
    """Validate a kernel operand: device, dtype, rank, unit inner stride."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: innermost stride must be 1, "
                         f"got strides {t.stride()}")
