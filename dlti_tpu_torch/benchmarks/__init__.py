"""Load-testing + benchmark reporting (the port's copy of
``dlti_tpu.benchmarks``, JAX-free as the original is).

The reference pins ``locust==2.29.0`` and ``aiohttp==3.10.0``
(``requirements.txt:35-36``) and claims "Benchmarking: Locust, AsyncIO"
(``README.md:11,17``) but ships no benchmark code (SURVEY.md §0). This
package is that leg, dependency-free.
"""

from dlti_tpu_torch.benchmarks.loadgen import LoadGenConfig, LoadReport, run_load_test  # noqa: F401
from dlti_tpu_torch.benchmarks.traces import (  # noqa: F401
    TRACE_FORMAT,
    TraceEvent,
    read_trace,
    synthesize,
    trace_summary,
    write_trace,
)
