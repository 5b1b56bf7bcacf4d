"""Processing-tree helpers the CLI's tree mode needs: a copy of
``upsp_tpu/processing/context.py``."""
