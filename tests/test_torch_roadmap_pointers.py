"""The port's not-ported errors point into ROADMAP.md by an item's title.

Every string in ``src/repro_torch/`` that says ``ROADMAP.md Queue N,
'Title'`` (adjacent literals joined, as the parser joins them) must name a
bold item title of that queue in ROADMAP.md; none may point at an item by
its number, which moves whenever the queue is re-ranked.
"""

import ast
import pathlib
import re

import pytest

import _torch_parity  # noqa: F401  (one torch thread per xdist worker)

ROOT = pathlib.Path(__file__).resolve().parents[1]
POINTER = re.compile(r"ROADMAP\.md\s+Queue\s+(\d+),\s+'([^']+)'")
BY_NUMBER = re.compile(r"ROADMAP\.md\s+Queue\s+\d+,\s+items?\s+\d")


def _strings(path):
    """Every string literal of the module, f-strings with ``{}`` in place of
    their fields."""
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield node.value
        elif isinstance(node, ast.JoinedStr):
            yield "".join(v.value if isinstance(v, ast.Constant) else "{}" for v in node.values)


def _pointers():
    found = []
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        for text in _strings(path):
            assert not BY_NUMBER.search(text), f"{path}: points at a ROADMAP item by number"
            found += [(path.relative_to(ROOT), int(q), t) for q, t in POINTER.findall(text)]
    return found


def _queue_text(queue: int) -> str:
    roadmap = (ROOT / "ROADMAP.md").read_text(encoding="utf-8")
    start = roadmap.index(f"### Queue {queue} ")
    end = roadmap.find("\n### ", start + 1)
    return roadmap[start:end if end >= 0 else None]


def test_not_ported_errors_name_roadmap_items_by_title():
    pointers = _pointers()
    # the sites of models/ and launch/ (the LM's sharded execution)
    assert len(pointers) >= 4, pointers
    for path, queue, title in pointers:
        assert f"**{title}" in _queue_text(queue), (
            f"{path}: ROADMAP.md Queue {queue} has no item titled {title!r}")


@pytest.mark.parametrize("text", ["see ROADMAP.md Queue 1, item 9", "ROADMAP.md\nQueue 1, items 6"])
def test_a_pointer_by_number_is_caught(text):
    assert BY_NUMBER.search(text)
