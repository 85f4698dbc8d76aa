"""ResNet-50 (He et al. 2015, "Deep Residual Learning for Image
Recognition", Table 1, 50-layer) as a node list for reference/net.py.

Bottleneck blocks of 1x1 -> 3x3 -> 1x1 convolutions, each followed by
BatchNorm, with a projection shortcut (1x1 conv + BatchNorm) on the first
block of each stage, the stride on the first 1x1 (the layout of DL4J's
zoo model, which the program serves), and ReLU after the residual sum.
Departures from the paper, as the served model has them: every
convolution carries a bias; the stem's 3x3 max pool pads SAME. Layer
names follow the program's zoo (`s3b0_a_conv`, ...), so one parameter
dict serves both sides.
"""

from __future__ import annotations


def _conv_bn(nodes, name, inp, cout, k, s, bn, act=True):
    nodes.append({"name": f"{name}_conv", "op": "conv", "inputs": [inp],
                  "k": [k, k], "s": [s, s], "cout": cout})
    nodes.append({"name": f"{name}_bn", "op": "bn",
                  "inputs": [f"{name}_conv"], **bn})
    if not act:
        return f"{name}_bn"
    nodes.append({"name": f"{name}_act", "op": "relu",
                  "inputs": [f"{name}_bn"]})
    return f"{name}_act"


def build(cfg: dict) -> list:
    bn = {"eps": cfg["bn"]["eps"], "decay": cfg["bn"]["decay"]}
    stem = cfg["stem"]
    nodes = [{"name": "input", "op": "input", "shape": cfg["input_shape"]}]
    x = _conv_bn(nodes, "stem", "input", stem["filters"], stem["kernel"],
                 stem["stride"], bn)
    nodes.append({"name": "stem_pool", "op": "maxpool", "inputs": [x],
                  "k": [stem["pool_kernel"]] * 2,
                  "s": [stem["pool_stride"]] * 2})
    x = "stem_pool"
    for st in cfg["stages"]:
        f1, f2, f3 = st["filters"]
        for i in range(st["blocks"]):
            name = f"{st['name']}b{i}"
            s = st["stride"] if i == 0 else 1
            y = _conv_bn(nodes, f"{name}_a", x, f1, 1, s, bn)
            y = _conv_bn(nodes, f"{name}_b", y, f2, 3, 1, bn)
            y = _conv_bn(nodes, f"{name}_c", y, f3, 1, 1, bn, act=False)
            sc = (_conv_bn(nodes, f"{name}_sc", x, f3, 1, s, bn, act=False)
                  if i == 0 else x)
            nodes.append({"name": f"{name}_add", "op": "add",
                          "inputs": [y, sc]})
            nodes.append({"name": f"{name}_out", "op": "relu",
                          "inputs": [f"{name}_add"]})
            x = f"{name}_out"
    nodes.append({"name": "avgpool", "op": "gap", "inputs": [x]})
    nodes.append({"name": "output", "op": "output", "inputs": ["avgpool"],
                  "cout": cfg["num_classes"]})
    return nodes


# BatchNorm layers that close a residual branch: the weight maker gives
# them a small gamma, as trained ResNets have, so the random network stays
# near the identity and does not amplify rounding block by block
def small_gamma(name: str) -> bool:
    return name.endswith("_c_bn")
