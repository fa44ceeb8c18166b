"""Build, load and count the port's hand-written CUDA kernels.

Every kernel lives in a ``csrc/*.cu`` source with a plain C entry point.
Each source is compiled once with ``nvcc`` for ``sm_90a`` into
``build/torch_kernels/`` at the root of the checkout (a directory
``.gitignore`` lists) on first CUDA use, rebuilt whenever it or a shared
header changes, and loaded with ``ctypes``; kernels that share a source
share its library and count their launches apart. Nothing here runs at
import time: the CPU tests import every module on machines with no
``nvcc`` and no card.

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
import functools
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
        for part in (*sorted(CSRC.glob("*.cuh")), CSRC / self.source):
            h.update(part.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{Path(self.source).stem}_{h.hexdigest()[:16]}.so"


KERNELS: Dict[str, Kernel] = {k.name: k for k in (
    Kernel("decode_attention", "decode_attention.cu",
           "backpacks_flash_attn_tpu/ops/decode_attention.py:77"),
    Kernel("quant_matmul", "quant_matmul.cu",
           "backpacks_flash_attn_tpu/ops/quant.py:161"),
    Kernel("flash_attention", "flash_attention.cu",
           "backpacks_flash_attn_tpu/ops/flash_attention.py:298"),
    Kernel("fused_contextualization", "fused_contextualization.cu",
           "backpacks_flash_attn_tpu/ops/backpack_kernels.py:281"),
    Kernel("flash_attention_bwd", "flash_attention_bwd.cu",
           "backpacks_flash_attn_tpu/ops/flash_attention.py:794"),
    Kernel("fused_contextualization_bwd", "fused_contextualization_bwd.cu",
           "backpacks_flash_attn_tpu/ops/backpack_kernels.py:345"),
    # K8: one source whose two key formats count their launches apart (int4
    # keys: the GPT layers; split int8 keys: the Backpack combine over the
    # mixed cache)
    Kernel("lowbit_decode_int4", "lowbit_decode_attention.cu",
           "backpacks_flash_attn_tpu/ops/decode_attention.py:667"),
    Kernel("lowbit_decode_mixed", "lowbit_decode_attention.cu",
           "backpacks_flash_attn_tpu/ops/decode_attention.py:808"),
    # the (m, l) forms of K1 and K8 (int4 keys), the main segments of the
    # staged serving decode
    Kernel("decode_attention_ml", "decode_attention.cu",
           "backpacks_flash_attn_tpu/ops/decode_attention.py:77"),
    Kernel("lowbit_decode_int4_ml", "lowbit_decode_attention.cu",
           "backpacks_flash_attn_tpu/ops/decode_attention.py:1205"),
    # K1's three redesigns: one source, each form counted apart
    Kernel("decode_attention_gathered", "decode_attention_variants.cu",
           "backpacks_flash_attn_tpu/ops/decode_attention.py:238"),
    Kernel("decode_attention_selector", "decode_attention_variants.cu",
           "backpacks_flash_attn_tpu/ops/decode_attention.py:365"),
    Kernel("decode_attention_blockdiag", "decode_attention_variants.cu",
           "backpacks_flash_attn_tpu/ops/decode_attention.py:465"),
    # K7, the fused MLP forward of training
    Kernel("fused_mlp_fwd", "fused_mlp.cu",
           "backpacks_flash_attn_tpu/ops/fused_mlp.py:81"),
    # K9, block-sparse attention: the forward on K3's body, and the backward
    # on K5's single pass, which replaces both of JAX's backward bodies
    # (_bs_bwd_dq_kernel :1242, _bs_bwd_dkv_kernel :1284, called from :1362)
    Kernel("blocksparse_fwd", "blocksparse_attention.cu",
           "backpacks_flash_attn_tpu/ops/flash_attention.py:1185"),
    Kernel("blocksparse_bwd", "blocksparse_attention_bwd.cu",
           "backpacks_flash_attn_tpu/ops/flash_attention.py:1362"),
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
    missing = {}
    for k in todo:
        if not k.library_path().exists():
            missing.setdefault(k.library_path(), []).append(k)
    if missing:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for out, users in missing.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / users[0].source)]
            procs.append((users, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for users, out, tmp, proc in procs:
            log, _ = proc.communicate()
            for k in users:
                k.build_log = log
            if proc.returncode != 0:
                failed.append(f"{users[0].source}:\n{log}")
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
    """Call the C entry ``symbol`` of ``kernel`` on the device of its first
    tensor operand (a ``Ptr`` made from a CUDA tensor) and that device's
    current stream (appended as the last argument); raise on a non-zero
    ``cudaGetLastError()``; count the launch. The C entries launch on the
    current CUDA device, so a device guard is entered when the operands lie
    on another one."""
    lib = load(kernel)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = [_ctype(a) for a in args] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    current = torch.cuda.current_device()
    dev = next((a.device for a in args
                if isinstance(a, Ptr) and a.device is not None), current)
    # the raw stream query: a few microseconds cheaper a launch than
    # building a torch.cuda.Stream
    if dev == current:
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
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
    """A device pointer argument (``Ptr.of(tensor)``; None -> NULL) and the
    index of the CUDA device it lies on (None: no tensor, or not CUDA)."""
    device: Optional[int] = None

    @classmethod
    def of(cls, t: Optional[torch.Tensor]) -> "Ptr":
        if t is None:
            return cls(None)
        p = cls(t.data_ptr())
        p.device = t.device.index
        return p


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

@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The streaming multiprocessors of a CUDA device (the launch shapes of
    K2 and K4 are sized to fill them)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


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


def aligned16(t: torch.Tensor) -> bool:
    """Whether every row of t starts on a 16-byte boundary (the vector
    loads of the mma.sync kernels): aligned base, outer strides a multiple
    of 8 elements (for 2-byte types)."""
    return (t.data_ptr() % 16 == 0
            and all(st % 8 == 0 for st in t.stride()[:-1]))


def kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """t itself when a backward kernel can read it in place (unit inner
    stride; in bf16 also rows 16-byte aligned), else a contiguous copy.
    Autograd hands a backward expanded cotangents (stride 0) as well."""
    ok = t.stride(-1) == 1 and (t.dtype != torch.bfloat16 or aligned16(t))
    return t if ok else t.contiguous()
