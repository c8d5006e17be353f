"""What the port does not run yet is refused with NotImplementedError, and
each refusal names its ROADMAP.md Queue 1 item by title, not by number, so
that renumbering the queue cannot make a message stale: the title must
stand in ROADMAP.md as the bold heading of an item."""

from __future__ import annotations

import dataclasses
import os
import re

import pytest

from scenelib2_torch.config import Params
from scenelib2_torch.runtime import step as step_mod
from scenelib2_torch.runtime.step import (
    ROADMAP_F64,
    ROADMAP_MAXP,
    ROADMAP_XLA,
    make_batch_step,
    make_step,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

P = Params()
REFUSALS = {
    "xla single stream": (ROADMAP_XLA, lambda: make_step(dataclasses.replace(P, use_pallas=False), device="cpu")),
    "xla batch": (ROADMAP_XLA, lambda: make_batch_step(dataclasses.replace(P, use_pallas=False), device="cpu")),
    "f64 single stream": (ROADMAP_F64, lambda: make_step(P, device="cpu", precision="f64")),
    "f64 batch": (ROADMAP_F64, lambda: make_batch_step(P, device="cpu", precision="f64")),
    "maxp single stream": (ROADMAP_MAXP, lambda: make_step(
        dataclasses.replace(P, max_features_to_init_at_once=2), device="cpu")),
    "maxp batch": (ROADMAP_MAXP, lambda: make_batch_step(
        dataclasses.replace(P, max_features_to_init_at_once=2), device="cpu")),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusal_names_its_roadmap_item_by_title(case):
    title, build = REFUSALS[case]
    with pytest.raises(NotImplementedError) as e:
        build()
    assert step_mod.roadmap_item(title) in str(e.value)
    assert not re.search(r"item \d", str(e.value)), str(e.value)


@pytest.mark.parametrize("title", [ROADMAP_XLA, ROADMAP_F64, ROADMAP_MAXP])
def test_each_title_heads_an_item_of_the_roadmap(title):
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        text = f.read()
    queue1 = text.split("### Queue 1", 1)[1].split("### Queue 2", 1)[0]
    assert re.search(r"^\d+\. \*\*" + re.escape(title) + r"\b", queue1, re.M), title
