"""The redundancy seam of the FT stack (port of the scheme classes of
``src/repro/ft/coding.py``).

Only the seam and the paper's own scheme are ported: ``CodingScheme`` and
``XORPairScheme``, whose redundancy is the pair mirroring already inside
the sweep arithmetic, so its ``refresh`` is the identity and it has no
joint decode. ``MDSScheme`` and the GF(2^8) checksum slots are not ported
yet, so ``recover_lanes`` never reaches a joint decode in the port. The
XOR pairing helpers (``xor_buddy``, ``pairing_table``) live in
``repro_torch.core.recovery``.
"""
from __future__ import annotations

from repro_torch.ft.failures import UnrecoverableFailure


class CodingScheme:
    """The redundancy seam of the FT stack.

    ``f``        guaranteed number of simultaneous deaths recoverable;
    ``joint``    whether ``decode_lanes`` exists (multi-death decode);
    ``refresh``  re-encode the parity slots at an interruptible boundary
                 (identity for pure XOR pairing);
    ``decode_lanes``  jointly reconstruct all newly-dead lanes, returning
                 ``(state, reads)`` with the multi-source decode ledger.

    ``recover_lanes`` (``repro_torch.ft.driver``) consults the scheme: one
    newly dead lane always takes the paper's single-source XOR REBUILD;
    ``2 <= t <= f`` takes ``decode_lanes``; more falls back to the per-lane
    XOR loop, whose exhaustion raises ``UnrecoverableFailure``."""

    name = "base"
    f = 0
    joint = False

    def refresh(self, comm, state):
        return state

    def decode_lanes(self, comm, state, newly, dead):
        raise UnrecoverableFailure(
            f"scheme {self.name!r} cannot jointly decode {sorted(newly)}")


class XORPairScheme(CodingScheme):
    """The paper's scheme: pairwise XOR-buddy redundancy, single-source
    REBUILD, f=1 per pair."""

    name = "xor"
    f = 1
    joint = False
