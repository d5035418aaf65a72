"""Newick parsing + tree rendering (ASCII art and PNG).

Replaces the reference's ete3 usage (calculate_distance.py:206-233): the
``.tree`` file carries ete3-style ASCII art (``/-``, ``\\-``, ``--|``), the
``.png`` a left-to-right phylogram with leaf names and a title, rendered with
matplotlib (no X server needed, unlike ete3's Qt backend which forced the
xvfb wrapper calculate_distance.sh:3).

Copy of ``pykmer_tpu/analysis/tree.py``, held against it
by ``tests/test_torch_copies.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class TreeNode:
    name: str = ""
    length: float = 0.0
    children: List["TreeNode"] = field(default_factory=list)

    @property
    def is_leaf(self) -> bool:
        return not self.children

    def leaves(self) -> List["TreeNode"]:
        if self.is_leaf:
            return [self]
        out: List[TreeNode] = []
        for child in self.children:
            out.extend(child.leaves())
        return out


def parse_newick(text: str) -> TreeNode:
    """Parse a newick string (names, branch lengths, quoted labels)."""
    text = text.strip()
    if text.endswith(";"):
        text = text[:-1]
    pos = 0

    def parse_node() -> TreeNode:
        nonlocal pos
        node = TreeNode()
        if pos < len(text) and text[pos] == "(":
            pos += 1
            while True:
                node.children.append(parse_node())
                if pos < len(text) and text[pos] == ",":
                    pos += 1
                    while pos < len(text) and text[pos] == " ":
                        pos += 1
                    continue
                break
            assert pos < len(text) and text[pos] == ")", f"bad newick at {pos}"
            pos += 1
        node.name = parse_label()
        if pos < len(text) and text[pos] == ":":
            pos += 1
            start = pos
            while pos < len(text) and text[pos] not in ",();":
                pos += 1
            node.length = float(text[start:pos])
        return node

    def parse_label() -> str:
        nonlocal pos
        if pos < len(text) and text[pos] == "'":
            pos += 1
            out = []
            while pos < len(text):
                if text[pos] == "'":
                    if pos + 1 < len(text) and text[pos + 1] == "'":
                        out.append("'")
                        pos += 2
                        continue
                    pos += 1
                    break
                out.append(text[pos])
                pos += 1
            return "".join(out)
        start = pos
        while pos < len(text) and text[pos] not in ",():;":
            pos += 1
        return text[start:pos]

    root = parse_node()
    return root


def render_ascii(tree: TreeNode) -> str:
    """ete3-style ASCII art of the tree topology."""
    lines, _ = _ascii_node(tree, char1="-")
    return "\n" + "\n".join(lines)


def _ascii_node(node: TreeNode, char1: str) -> Tuple[List[str], int]:
    """Returns (lines, index of the node's attachment row)."""
    if node.is_leaf:
        return [f"{char1}-{node.name}"], 0

    child_blocks = []
    for idx, child in enumerate(node.children):
        if len(node.children) == 1:
            branch = "-"
        elif idx == 0:
            branch = "/"
        elif idx == len(node.children) - 1:
            branch = "\\"
        else:
            branch = "|"
        child_blocks.append(_ascii_node(child, branch))

    lines: List[str] = []
    attach_rows: List[int] = []
    for bi, (block, attach) in enumerate(child_blocks):
        if bi > 0:
            lines.append("  |")
        attach_rows.append(len(lines) + attach)
        lines.extend("  " + line for line in block)

    mid = (attach_rows[0] + attach_rows[-1]) // 2
    out: List[str] = []
    for i, line in enumerate(lines):
        if i == mid:
            prefix = f"{char1}-|"
        elif attach_rows[0] <= i <= attach_rows[-1]:
            prefix = "  |"
        else:
            prefix = "   "
        # merge prefix with the line's leading spaces
        out.append(prefix + line[3:] if line.startswith("  ") else prefix + line)
    return out, mid


def render_png(
    tree: TreeNode,
    path: str,
    title: str = "",
    height_px: int = 800,
    width_px: int = 400,
    dpi: int = 72,
) -> Optional[str]:
    """Left-to-right phylogram PNG via matplotlib (returns path, or None if
    matplotlib is unavailable)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None

    leaves = tree.leaves()
    ys = {id(leaf): i for i, leaf in enumerate(leaves)}

    segments = []
    labels = []

    def layout(node: TreeNode, x0: float) -> float:
        x1 = x0 + max(node.length, 0.0)
        if node.is_leaf:
            y = ys[id(node)]
            segments.append(((x0, y), (x1, y)))
            labels.append((x1, y, node.name))
            return y
        child_ys = [layout(c, x1) for c in node.children]
        y = (min(child_ys) + max(child_ys)) / 2.0
        segments.append(((x0, y), (x1, y)))
        segments.append(((x1, min(child_ys)), (x1, max(child_ys))))
        return y

    layout(tree, 0.0)

    fig, ax = plt.subplots(figsize=(width_px / dpi, height_px / dpi), dpi=dpi)
    for (xa, ya), (xb, yb) in segments:
        ax.plot([xa, xb], [ya, yb], color="black", linewidth=1)
    for x, y, name in labels:
        ax.text(x, y, " " + name, va="center", fontsize=8)
    if title:
        ax.set_title(title, fontsize=20)
    ax.set_yticks([])
    ax.set_xlabel("distance")
    ax.spines[["top", "right", "left"]].set_visible(False)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path
