"""GoogLeNet / Inception-v1 (Szegedy et al. 2014, "Going deeper with
convolutions", Table 1) as a node list for reference/net.py.

Inception modules of four branches (1x1; 1x1 -> 3x3; 1x1 -> 5x5; a 3x3
stride-1 max pool -> 1x1), concatenated along channels in that order,
every convolution followed by BatchNorm and ReLU, then a global average
pool, dropout and a softmax classifier. Departures from the paper, as
the repository's zoo network has them: BatchNorm after each
convolution and no local response normalization, no auxiliary
classifiers, every max pool SAME-padded, every convolution with a bias.
Layer names follow the program's zoo (`i4a_3x3r_conv`, ...).
"""

from __future__ import annotations


def _conv_bn(nodes, name, inp, cout, k, s, bn):
    nodes.append({"name": f"{name}_conv", "op": "conv", "inputs": [inp],
                  "k": [k, k], "s": [s, s], "cout": cout})
    nodes.append({"name": f"{name}_bn", "op": "bn",
                  "inputs": [f"{name}_conv"], **bn})
    nodes.append({"name": f"{name}_act", "op": "relu",
                  "inputs": [f"{name}_bn"]})
    return f"{name}_act"


def _pool(nodes, name, inp, s):
    nodes.append({"name": name, "op": "maxpool", "inputs": [inp],
                  "k": [3, 3], "s": [s, s]})
    return name


def build(cfg: dict) -> list:
    bn = {"eps": cfg["bn"]["eps"], "decay": cfg["bn"]["decay"]}
    nodes = [{"name": "input", "op": "input", "shape": cfg["input_shape"]}]
    x = "input"
    for item in cfg["layers"]:
        kind = item["kind"]
        if kind == "conv":
            x = _conv_bn(nodes, item["name"], x, item["cout"], item["k"],
                         item["s"], bn)
        elif kind == "pool":
            x = _pool(nodes, item["name"], x, item["s"])
        elif kind == "inception":
            name = item["name"]
            f1, f3r, f3, f5r, f5, pp = item["filters"]
            b1 = _conv_bn(nodes, f"{name}_1x1", x, f1, 1, 1, bn)
            b3 = _conv_bn(nodes, f"{name}_3x3r", x, f3r, 1, 1, bn)
            b3 = _conv_bn(nodes, f"{name}_3x3", b3, f3, 3, 1, bn)
            b5 = _conv_bn(nodes, f"{name}_5x5r", x, f5r, 1, 1, bn)
            b5 = _conv_bn(nodes, f"{name}_5x5", b5, f5, 5, 1, bn)
            pool = _pool(nodes, f"{name}_pool", x, 1)
            bp = _conv_bn(nodes, f"{name}_poolproj", pool, pp, 1, 1, bn)
            nodes.append({"name": f"{name}_concat", "op": "concat",
                          "inputs": [b1, b3, b5, bp]})
            x = f"{name}_concat"
        else:
            raise ValueError(f"unknown GoogLeNet layer kind {kind!r}")
    nodes.append({"name": "avgpool", "op": "gap", "inputs": [x]})
    nodes.append({"name": "drop", "op": "dropout", "inputs": ["avgpool"],
                  "rate": cfg["dropout"]})
    nodes.append({"name": "output", "op": "output", "inputs": ["drop"],
                  "cout": cfg["num_classes"]})
    return nodes


def small_gamma(name: str) -> bool:
    return False
