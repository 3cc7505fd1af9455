"""The paper's own workload configs: FT-CAQR of general matrices (port of
``src/repro/configs/paper_qr.py``).

These parameterize the dry run's ``caqr`` cell and the QR autotuner's
cells; the shapes follow the communication-avoiding literature's tall
panels, b = 128 the widest panel of the port's one-block kernel bodies.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class QRConfig:
    name: str
    m_rows: int
    n_cols: int
    panel: int


PRODUCTION = QRConfig("caqr-prod", m_rows=65536, n_cols=4096, panel=128)
SMOKE = QRConfig("caqr-smoke", m_rows=512, n_cols=128, panel=16)
