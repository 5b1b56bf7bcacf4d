"""Pipeline/Datapoint context: path resolution over the processing tree.

Parity: python/upsp/processing/context.py (studied, not copied).
"""

from __future__ import annotations

import json
import os
from typing import List


class Pipeline:
    """Resolves file paths inside a generated uPSP processing tree."""

    def __init__(self, root_dir: str, ctx_filename: str = None):
        self.root_dir = root_dir
        self.output_dir = os.path.join(root_dir, "05_products", "00_data")
        self.ctx_filename = ctx_filename or os.path.join(root_dir, "context.json")
        with open(self.ctx_filename) as f:
            self.ctx = json.load(f)

    @property
    def datapoints(self) -> List["Datapoint"]:
        return [self.datapoint(name) for name in self.ctx["datapoints"]]

    def datapoint(self, name: str) -> "Datapoint":
        return Datapoint(self, name)


class Datapoint:
    """Per-datapoint path resolution + input metadata."""

    def __init__(self, pipeline: Pipeline, name: str):
        self.pipeline = pipeline
        self.name = str(name)

    @property
    def inputs(self) -> dict:
        return self.pipeline.ctx["datapoints"][self.name]

    @property
    def processing(self) -> dict:
        return self.pipeline.ctx["processing"][self.name]

    def output_path(self, step: str, *args) -> str:
        return os.path.join(self.pipeline.output_dir, step, self.name, *args)

    def input_deck_path(self) -> str:
        return os.path.join(
            self.pipeline.root_dir, "04_processing", "psp_process", self.name,
            "input_deck.inp",
        )

    def pressure_transpose_path(self) -> str:
        return self.output_path("psp_process", "pressure_transpose")
