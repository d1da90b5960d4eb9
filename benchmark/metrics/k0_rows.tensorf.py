"""Rows the TensoRF k0 query computed a step (the program's ``k0_rows``
counter: the head's rows, its live prefix rounded up to 1,024), over the
traced window."""
from typing import Dict, Optional


def read(rec: Dict) -> Optional[float]:
    p = rec.get("program")
    rows = p["counters"].get("k0_rows") if p else None
    if rec["kind"] != "train_tensorf" or rows is None or not rec.get("units"):
        return None
    return rows / rec["units"]
