"""Host milliseconds a step: the benchmark's span around the batch draw
and the step call, with no synchronize, over the untraced window."""
from typing import Dict, Optional


def read(rec: Dict) -> Optional[float]:
    ms = rec["e2e"].get("host_ms")
    if rec["kind"] != "train_tensorf" or not ms:
        return None
    return sum(ms) / len(ms)
