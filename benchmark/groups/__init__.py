"""Kernel groups added by data: one file ``groups/<group>.py`` a group,
named by its file, holding ``FRAGMENTS`` (fragments of the kernel names
it takes) and ``bound_s(cell)``: the least seconds a step of the
group's logical work takes at ``counts.PEAKS``, or ``None`` where the
group does not run in the cell (``cell`` as ``counts.kernel_bounds``
takes it).  A group file takes only kernel names that the frozen
``record.BUCKETS`` leave as "other" (``record.bucket``), so no group
that is there changes; a kernel name that two group files match is an
error.  A group's roofline is then one more file,
``metrics/<group>_roofline.py``, reading ``readers.roofline("<group>")``.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, NamedTuple, Optional, Tuple

GROUPS_DIR = Path(__file__).resolve().parent


class Group(NamedTuple):
    name: str
    fragments: Tuple[str, ...]
    bound_s: Callable[[Dict], Optional[float]]


def load(directory: Path = GROUPS_DIR) -> Tuple[Group, ...]:
    """Every group file of ``directory``, in name order."""
    from benchmark import record
    from benchmark.spec import load_module

    out = []
    for path in sorted(Path(directory).glob("*.py")):
        if path.name.startswith("_"):
            continue
        if path.stem in record.FROZEN_NAMES:
            raise ValueError(f"the group file {path.name} takes the name of "
                             "a frozen group")
        mod = load_module(path, "benchmark_group_")
        out.append(Group(path.stem, tuple(mod.FRAGMENTS), mod.bound_s))
    return tuple(out)
