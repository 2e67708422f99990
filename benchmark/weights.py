"""Model weights from the seed: one draw on the device per model, in the
reference's tree form.

Leaves follow the encoders' default initialisation (``Dense`` kernels
[in, out] with std 1/sqrt(in), the token table with std 1/sqrt(dim),
LayerNorm scale 1 and bias 0, the cross-encoder's head with zero biases).
Trunk weights and the token table are rounded to the type they are served
in, so the program (which casts them to that type) and the f32 reference
hold the same values.  The cross-encoder's head is f32 on both sides.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

STREAM_ENCODER = 11
STREAM_CROSS = 12


def stream_seed(seed: int, stream: int) -> int:
    return (int(seed) * 1_000_003 + stream) % (1 << 63)


def _layout(cfg: dict, head: bool) -> List[Tuple[str, tuple, float, bool]]:
    """(path, shape, std, served-type) of every random leaf, in order."""
    D, V = cfg["dim"], cfg["vocab_size"]
    H = D * cfg["mlp_ratio"]
    leaves = [("tok/embedding", (V, D), 1 / math.sqrt(D), True)]
    for i in range(cfg["n_layers"]):
        for name, shape in (("attn/qkv", (D, 3 * D)), ("attn/proj", (D, D)),
                            ("mlp/wi", (D, 2 * H)), ("mlp/wo", (H, D))):
            leaves.append((f"block{i}/{name}/kernel", shape,
                           1 / math.sqrt(shape[0]), True))
    if head:
        leaves += [("head_hidden/kernel", (D, D), 1 / math.sqrt(D), False),
                   ("head_out/kernel", (D, 1), 1 / math.sqrt(D), False)]
    return leaves


def draw_tree(seed: int, cfg: dict, head: bool, device) -> Dict:
    """The tree as f32 tensors on ``device`` (``head``: a cross-encoder)."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(stream_seed(seed, STREAM_CROSS if head else STREAM_ENCODER))
    layout = _layout(cfg, head)
    flat = torch.randn(sum(math.prod(s) for _, s, _, _ in layout),
                       generator=g, device=dev)
    served = getattr(torch, cfg["dtype"])
    D = cfg["dim"]
    tree: Dict = {}
    at = 0
    for path, shape, std, rounded in layout:
        n = math.prod(shape)
        x = flat[at : at + n].view(shape) * std
        at += n
        if rounded:
            x = x.to(served).to(torch.float32)
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = x
    del flat

    def ln():
        return {"scale": torch.ones(D, device=dev),
                "bias": torch.zeros(D, device=dev)}

    for i in range(cfg["n_layers"]):
        tree[f"block{i}"]["ln1"] = ln()
        tree[f"block{i}"]["ln2"] = ln()
    tree["ln_f"] = ln()
    if head:
        tree["head_hidden"]["bias"] = torch.zeros(D, device=dev)
        tree["head_out"]["bias"] = torch.zeros(1, device=dev)
    return tree


def to_numpy(tree: Dict) -> Dict:
    """The same tree with numpy f32 leaves (the form the program loads)."""
    return {k: to_numpy(v) if isinstance(v, dict)
            else v.detach().cpu().numpy().astype(np.float32, copy=False)
            for k, v in tree.items()}
