"""Declared Hopper kernel contracts.

The port's counterpart of ``arrow_matrix_tpu/ops/kernel_contract.py``.
The reference declares the TPU envelope of its Pallas kernels (row
blocks, DMA rings, waves, SMEM/VMEM budgets, a granule).  The card has
none of those: a contract here declares what an NVIDIA Hopper (sm_90)
launch of one hand-written kernel promises to stay inside:

* its threads per CTA, its static and dynamic shared memory, and the
  least CTAs an SM holds (``__launch_bounds__``), at each knob point;
* its launch knobs and the values it takes (K1: ``chunk_slots``,
  ``batch``, ``ctas_per_sm``; ``ops/worklist.py``);
* its k gate: 16-byte loads need ``k * itemsize % 16 == 0``, else the
  kernel takes its scalar path (``vec = 1``); every k >= 1 runs;
* its carriage dtypes, and its accumulator, which must be float32;
* the source declarations of its accumulators (the certifier's KC4
  reads them in the ``.cu``).

Three consumers read a contract: the certifier ``analysis/kernels.py``
(KC1-KC5 over the kernel's metas, verdicts in the port's manifest),
``tune/space.py`` (the k gate and candidate certification before any
child spawns) and ``tune/synth.py``, whose generated schedules enter
through :func:`register_kernel` and are certified like the builtins.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Callable, Dict, List, Optional, Tuple

#: Carriage dtypes a contract may declare, with their itemsizes.
CARRIAGE_ITEMSIZE: Dict[str, int] = {"f32": 4, "bf16": 2, "int8": 1}

#: Accumulator dtypes KC4 accepts.
WIDE_ACCUM_DTYPES = ("f32", "float32", "f64", "float64")

#: sm_90 limits (CUDA C++ Programming Guide, compute capability 9.0).
SM90_SMEM_PER_CTA = 227 * 1024
SM90_SMEM_PER_SM = 228 * 1024
SM90_REGS_PER_SM = 65536
SM90_MAX_REGS_PER_THREAD = 255
SM90_MAX_THREADS_PER_CTA = 1024
SM90_MAX_THREADS_PER_SM = 2048
SM90_MAX_CTAS_PER_SM = 32
SM90_GRID_Y_MAX = 65535
#: A CTA's static shared memory without an opt-in (``__shared__``).
SM90_STATIC_SMEM = 48 * 1024

#: Bytes of one vector load of the kernels.
VECTOR_BYTES = 16


@dataclass(frozen=True)
class KernelContract:
    """The declared envelope of one hand-written Hopper kernel."""

    name: str                 # the kernel (its C entry's library)
    module: str               # the wrapper module that launches it
    kind: str                 # "k1_worklist" | "dense_blocks" | "row_gather"
    source: str               # the .cu, relative to the package
    threads: int              # threads of a CTA (the largest launch)
    ctas_per_sm: Tuple[int, ...] = (1,)   # launch-bound values taken
    static_smem_bytes: int = 0            # the largest static footprint
    dynamic_smem_bytes: int = 0           # the largest dynamic footprint
    #: Knob name -> the values the kernel takes, as sorted pairs.
    knobs: Tuple[Tuple[str, Tuple], ...] = ()
    ks: Tuple[int, ...] = (16, 128)
    carriage_dtypes: Tuple[str, ...] = ("f32",)
    accum_dtype: str = "f32"
    #: Declarations of the accumulators, as they stand in the source.
    accum_decls: Tuple[str, ...] = ()

    def supports_k(self, k: int) -> bool:
        """The k gate both the wrapper and ``tune/space.py`` read: every
        k >= 1 runs (a row of ``k * itemsize`` bytes off 16 takes the
        scalar path, :meth:`vector_loads`)."""
        return int(k) >= 1

    def vector_loads(self, k: int, itemsize: int) -> bool:
        """Whether rows of ``k`` features of ``itemsize`` bytes take
        16-byte loads (``vec = 16 / itemsize``) rather than ``vec = 1``."""
        return int(k) * int(itemsize) % VECTOR_BYTES == 0

    def knob_values(self, name: str) -> Tuple:
        """The values the kernel takes for knob ``name`` (raises
        ``KeyError`` for a knob it does not have)."""
        return dict(self.knobs)[name]

    def to_json(self) -> dict:
        d = asdict(self)
        d["knobs"] = {k: list(v) for k, v in self.knobs}
        return d


@dataclass(frozen=True)
class KernelEntry:
    """One certifiable kernel: its contract, a callable producing its
    launch metas at the contract's knob points, its source for the
    source rules (KC4), and an optional boundary witness."""

    contract: KernelContract
    metas: Callable[[], List[dict]]
    source_path: Optional[str] = None
    source_text: Optional[str] = None
    #: Optional callable -> (ok, detail): a run in which every index
    #: points at the last row (the KC1 boundary witness).
    witness: Optional[Callable[[], Tuple[bool, str]]] = None

    @property
    def name(self) -> str:
        return self.contract.name

    def source(self) -> Optional[str]:
        if self.source_text is not None:
            return self.source_text
        if self.source_path is not None:
            with open(self.source_path, encoding="utf-8") as fh:
                return fh.read()
        return None


#: Registered (generated) kernels: :func:`register_kernel` adds one, the
#: certifier and the tuner's screens see it at once.
_REGISTRY: Dict[str, KernelEntry] = {}


def register_kernel(entry: KernelEntry) -> KernelEntry:
    """Register a kernel for certification; a name registered again
    replaces its entry (a regenerated program supersedes the old)."""
    _REGISTRY[entry.name] = entry
    return entry


def unregister_kernel(name: str) -> None:
    _REGISTRY.pop(name, None)


def builtin_kernels() -> List[KernelEntry]:
    """The three hand-written kernels: K1, K2/K3 and K4."""
    from arrow_matrix_tpu_torch.ops import cuda_blocks, cuda_gather, cuda_sell

    return [cuda_sell.kcert_entry(), cuda_blocks.kcert_entry(),
            cuda_gather.kcert_entry()]


#: One-shot guard for the generated-program load below.
_SYNTH_LOADED = False


def _load_persisted_programs() -> None:
    """Register the schedules persisted in the port's program store
    (``tune/synth.py``), once per process.  A missing store registers
    nothing; an unreadable one raises in ``tune/synth.load_store`` when
    the certifier reads it, which is where it is reported."""
    global _SYNTH_LOADED
    if _SYNTH_LOADED:
        return
    _SYNTH_LOADED = True
    from arrow_matrix_tpu_torch.tune import synth

    try:
        synth.register_persisted_programs()
    except ValueError as e:
        import sys

        print(f"[kernel-contract] program store not loaded: {e}",
              file=sys.stderr)


def registered_kernels() -> List[KernelEntry]:
    """Builtins first, then registered (generated) kernels, each name
    once: a registered entry shadows a builtin of the same name."""
    _load_persisted_programs()
    out: List[KernelEntry] = []
    seen = set(_REGISTRY)
    for e in builtin_kernels():
        if e.name not in seen:
            out.append(e)
    out.extend(_REGISTRY[name] for name in sorted(_REGISTRY))
    return out
