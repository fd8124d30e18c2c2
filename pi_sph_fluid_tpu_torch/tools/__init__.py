"""The TPU probes of ``tools/`` redone for the card, as CUDA kernels with
plain versions: ``unaligned_probe`` (window copies from aligned and odd
starts) and ``span_dma_probe`` (one staged window against several spans
per query block).  Each module runs as a script on the GPU."""
