"""Percent of the elements Adam updated that the masked Adam kernel
updated: the program's ``adam_fused_elems`` over ``adam_elems``, over
the traced window."""
from typing import Dict, Optional


def read(rec: Dict) -> Optional[float]:
    p = rec.get("program")
    c = p["counters"] if p else {}
    if rec["kind"] != "train" or not c.get("adam_elems"):
        return None
    return 100.0 * c.get("adam_fused_elems", 0) / c["adam_elems"]
