"""The calling pipeline: ``clair3_tpu.pipeline.call.VariantCaller``, reused.

``VariantCaller`` takes its engines by duck typing, so the port supplies
engines and does not copy the pipeline.  One import stands in the way:
``clair3_tpu/pipeline/call.py`` imports ``rescale_high_coverage_pileup``
from ``clair3_tpu.pipeline.engine``, which imports jax.  Unless jax is
already loaded in this process, a stand-in module holding the port's
jax-free copy of that function is registered under the engine's name before
the import, so the port never loads jax, whether or not it is installed.
Where jax is already loaded (as in the test suite, which imports both
packages in one process) the real module must win, or the JAX tests that
share the process would find the stand-in.  The clean fix moves the
function out of the JAX engine (ROADMAP Queue 1 item 13), which changes the
reference package.

Single-process calling only: with ``dist_process_count > 1`` the pipeline
imports ``clair3_tpu.parallel.distributed``, which needs jax.
"""

from __future__ import annotations

import sys
import types

from clair3_tpu_torch.pipeline.engine import rescale_high_coverage_pileup

_JAX_ENGINE = "clair3_tpu.pipeline.engine"

if _JAX_ENGINE not in sys.modules and "jax" not in sys.modules:
    _stand_in = types.ModuleType(_JAX_ENGINE, "jax-free stand-in (see "
                                 "clair3_tpu_torch/pipeline/call.py)")
    _stand_in.rescale_high_coverage_pileup = rescale_high_coverage_pileup
    sys.modules[_JAX_ENGINE] = _stand_in

from clair3_tpu.pipeline.call import VariantCaller  # noqa: E402

__all__ = ["VariantCaller"]
