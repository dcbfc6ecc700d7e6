"""CPU tests of the benchmark: tiny cells of BENCHMARK.json's cells, the
port on the CPU (its kernels' plain versions)."""
import copy
import os
import sys
from pathlib import Path

import pytest

os.environ.setdefault("VIDGRAPH_TORCH_DEVICE", "cpu")
ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.harness import manifest  # noqa: E402

INGEST, TRAIN = "ingest.vlm_large.b1", "train.chat_lm.b8x3072"
TINY_VIT = dict(image_size=64, patch_size=32, width=64, layers=2, heads=2,
                embed_dim=32, dtype="float32")
TINY_CAP = dict(width=32, layers=2, heads=2, vision_dim=32,
                num_vision_tokens=2, max_len=128, dtype="float32")


def tiny_ingest():
    cell = copy.deepcopy(manifest.cell(INGEST))
    cell.config["vit"].update(TINY_VIT)
    cell.config["captioner"].update(TINY_CAP, param_dtype="float32",
                                    max_len=64)
    cell.traffic.update(pool_chunks=3, frame_height=24, frame_width=40,
                        max_new=16)
    return cell


def tiny_train():
    cell = copy.deepcopy(manifest.cell(TRAIN))
    cell.config["captioner"].update(TINY_CAP)
    cell.traffic.update(batch=4, seq_len=48, trace_skip=1, trace_steps=2)
    return cell


@pytest.fixture
def ingest_cell():
    return tiny_ingest()


@pytest.fixture
def train_cell():
    return tiny_train()
