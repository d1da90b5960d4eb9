"""Device milliseconds a step credited to the program's ``k0`` spans (the
TensoRF query at the head's rows in ``forward``, its scatter into the
factors in ``backward``): every span path ending in ``/k0``, over the
traced window."""
from typing import Dict, Optional


def read(rec: Dict) -> Optional[float]:
    p = rec.get("program")
    if rec["kind"] != "train_tensorf" or not p or not rec.get("units"):
        return None
    paths = [k for k in p["device_s"] if k == "k0" or k.endswith("/k0")]
    if not paths:
        return None
    return 1e3 * sum(p["device_s"][k] for k in paths) / rec["units"]
