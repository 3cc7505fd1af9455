"""Serving of the port (counterpart of ``src/repro/serve/``): the
QR-as-a-service front end (continuous sweep batching, ``qr_service``).
The JAX package's token engine (``serve/engine.py``) is not ported yet."""
from repro_torch.serve.qr_service import QRRequest, QRResult, QRService

__all__ = ["QRRequest", "QRResult", "QRService"]
