"""Models of the port (counterpart of ``src/repro/models/``): the
transformer with global and sliding-window attention ('G', 'L'), dense
MLPs ('D') and mixtures of experts ('E'), its shared components and the
training loss. The SSM, RG-LRU, encoder and VLM families wait for their
port (``ROADMAP.md`` queue 1)."""
