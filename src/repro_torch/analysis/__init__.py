"""quadlint for the PyTorch port (counterpart of ``repro.analysis``).

``python -m repro_torch.analysis src/repro_torch`` walks the given paths
and enforces the reference's contracts where the port has them, in
torch's form:

  QL001  state-threading completeness: every field of QuadState /
         GQLState / CoeffHistory / BlockState / ChainFactor is claimed by
         the registries beside the classes and handled by the freeze
         loops, the sharded driver, the serving pool's admission and the
         per-step writers.
  QL005  no imports of the removed deprecation shims.
  QL006  no unkeyed randomness in library code: numpy's and the
         stdlib's global state, torch's samplers without ``generator=``,
         and seeding torch's global generators.
  QL007  collective cadence: a ``while`` round loop in core/ issues no
         raw ``torch.distributed`` collective -- round-boundary
         communication goes through ``core.sharded._round_gather``.
  QL008  host-side-only telemetry: no obs.metrics / obs.spans call or
         ``print()`` in a captured scope (a CUDA graph's capture or a
         ``torch.compile``d function, and the helpers they call).

QL002 (tracer leaks), QL003 (jit discipline) and QL004 (collective
pairing under ``lax.while_loop``) have no counterpart: eager torch has no
trace. A Python ``if`` on a tensor reads its value, nothing is compiled
per call, and a host round loop's continue flag is the gathered one, the
same on every rank.

Findings print as ``path:line RULE message``; suppress a deliberate
exception with ``# quadlint: disable=QLxxx -- reason`` (the reason is
mandatory). The engine is stdlib-only (``ast``); QL001 additionally
imports the port's modules to read the live field sets.
"""
from .engine import Finding, main, run_paths  # noqa: F401
