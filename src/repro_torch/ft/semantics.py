"""FT-MPI / ULFM error-handling semantics (paper §II), as a policy enum
(port of ``src/repro/ft/semantics.py``, copied).

When a process failure is detected, the surviving world chooses how to
continue. The port's sweep driver (``repro_torch.ft.driver``) implements
REBUILD, the mode the paper's recovery algorithm (§III-B/III-C) is written
for: the respawned rank's state is reconstructed from its re-read input
slice plus one surviving buddy per artifact. SHRINK and BLANK (the elastic
continuations) it hands to the elastic driver
(``repro_torch.ft.elastic.ft_caqr_sweep_elastic``).

>>> Semantics.REBUILD.value
'rebuild'
>>> [s.name for s in Semantics]
['SHRINK', 'BLANK', 'REBUILD', 'ABORT']
"""
from __future__ import annotations

import enum


class Semantics(enum.Enum):
    SHRINK = "shrink"    # drop the lane; survivors renumber; smaller world
    BLANK = "blank"      # keep the hole; rank invalid; survivors keep ranks
    REBUILD = "rebuild"  # respawn the rank; restore its state; same world
    ABORT = "abort"      # terminate everything (non-FT default)
