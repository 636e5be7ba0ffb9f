"""Measurement-backed tuning of the port (port of the reference
``tune/``).

Two knobs read a tuning table when the caller gives no value:

  * the distributed-attention schedule — ``DistAttnSpec(schedule="auto")``
    (``core/schedule.choose_schedule``: a measured row decides, else the
    table's calibrated coefficients rank the candidates, else the H100
    roofline of ``analysis/roofline.py``);
  * the paged cache's ``block_size`` (``serve/cache.PagedKVCache.
    default_block_size``).

:mod:`repro_torch.tune.table` holds the table — the reference's JSON
schema, validation, nearest-bucket lookups, and the process-wide
resolution (``set_table`` > ``REPRO_TUNE_TABLE`` > a bundled
``tables/default_<platform>.json`` > None; ``REPRO_TUNE=off`` skips it).
:mod:`repro_torch.tune.calibrate` fits the cost model's coefficients to
measured schedule rows; :mod:`repro_torch.tune.timing` holds the median
timers; :mod:`repro_torch.tune.sweep` measures and writes a table
(``tools/autotune_torch.py``).  No table ships with the port, so ``auto``
ranks by the roofline unless a table is loaded.
"""
from repro_torch.tune.table import (SCHEMA_VERSION, TableError, TuningTable,
                                    active_table, set_table)

__all__ = ["SCHEMA_VERSION", "TableError", "TuningTable", "active_table",
           "set_table"]
