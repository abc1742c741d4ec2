"""Trace lane names the serving engine and scheduler share (counterpart of
ddp_practice_tpu/utils/trace.py). The recorder itself comes with the
serving plane in a later slice; until then every tracer is None and the
dispatch paths use `NULL_SPAN`.
"""

import contextlib

ENGINE_LANE = 0          # tid for decode dispatches + scheduler instants
SLOT_LANE_BASE = 1       # tid = SLOT_LANE_BASE + slot for prefill spans

# the shared no-op span
NULL_SPAN = contextlib.nullcontext()
