"""Serving: the inference forward, its deployable artifact, the streaming
engine and the CLI.

Surface:
  export.export_serving / save_artifact / load_artifact / export_from_run
  export.make_serving_fn
  engine.ServingEngine
  python -m scaleprotoseg_torch.serving.serve  (CLI)

Importing it imports no model code: a loaded artifact serves without it.
"""

from scaleprotoseg_torch.serving.engine import ServingEngine  # noqa: F401
from scaleprotoseg_torch.serving.export import (  # noqa: F401
    export_from_run, export_serving, load_artifact, make_serving_fn,
    save_artifact)
