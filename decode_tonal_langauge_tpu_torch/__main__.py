"""Package entry point: ``python -m decode_tonal_langauge_tpu_torch
<config.yaml> [--device cpu]`` runs the pipeline (``pipeline.main``)."""

from .pipeline import main

if __name__ == "__main__":
    main()
