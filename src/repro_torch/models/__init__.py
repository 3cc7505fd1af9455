"""Models of the port (counterpart of ``src/repro/models/``): the dense
transformer (global attention 'G', dense MLP 'D') with its shared
components and the training loss. The MoE, SSM, RG-LRU, encoder and VLM
families wait for their port (``ROADMAP.md`` queue 1)."""
