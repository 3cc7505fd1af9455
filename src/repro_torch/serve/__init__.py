"""Serving of the port (counterpart of ``src/repro/serve/``): the token
engine (prefill + batched cached decode, ``engine``) and the
QR-as-a-service front end (continuous sweep batching, ``qr_service``)."""
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.qr_service import QRRequest, QRResult, QRService

__all__ = ["Engine", "ServeConfig", "QRRequest", "QRResult", "QRService"]
