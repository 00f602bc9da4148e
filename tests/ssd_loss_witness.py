"""SSD's two losses over the first training steps, on the reference and on
the port, on the CPU: ``ssd_train(20)`` at 300 x 300 with
``examples/ssd/train.py``'s settings (SGD lr 0.002, momentum 0.9, wd
5e-4, ``Xavier()``), both packages from the port's initial parameters
(seed 26, as ``chip_smoke.py``'s phase 26 draws them on the card)
carried by name, on one fixed ``SyntheticDetIter`` batch (seed 26) of
``--batch`` images, for ``--steps`` updates.

For each step it prints the class part (the cross entropy over the
anchors that are not ignored) and the box part (the mean smooth-L1 over
the matched box coordinates) of both packages, as ``chip_smoke.py``'s
phase 26 computes them on the card, and at the end the share of the
matched coordinates whose smooth-L1 fell from the first step to the last.
It is the witness of how fast the box part falls at these settings.
A third run, the port's with the box branch cut (its ``smooth_l1`` takes
no gradient, so only the class part trains), shows what the box part
does when the box branch never trains.

    JAX_PLATFORMS=cpu python tests/ssd_loss_witness.py --batch 2 --steps 20

The last line is one JSON object with both trajectories.
"""
import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("MXNET_PALLAS", "0")

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_detection import SyntheticDetIter  # noqa: E402

NUM_CLASSES = 20
OPT = {"learning_rate": 0.002, "momentum": 0.9, "wd": 5e-4}


def objective(outs):
    """(class part, box part) from ``[cls_prob, loc_loss, cls_label,
    det_out]`` as numpy, and the box loss by element."""
    prob, loc, label = outs[:3]
    valid = label >= 0
    idx = np.clip(label, 0, None).astype(np.int64)[:, None]
    p = np.take_along_axis(prob, idx, axis=1)[:, 0]
    ce = -(np.log(p) * valid).sum() / max(valid.sum(), 1)
    box = loc.sum() / max((loc != 0).sum(), 1)
    return float(ce), float(box), loc


def module(pkg, data, label):
    mod = pkg.mod.Module(pkg.models.ssd_train(num_classes=NUM_CLASSES),
                         data_names=("data",), label_names=("label",),
                         context=pkg.cpu())
    mod.bind(data_shapes=[("data", data.shape)],
             label_shapes=[("label", label.shape)])
    return mod


def initial_params(data, label):
    """The port's ``Xavier()`` draw from seed 26, as numpy by name."""
    mod = module(tmx, data, label)
    np.random.seed(26)
    tmx.random.seed(26)
    mod.init_params(initializer=tmx.init.Xavier())
    return {n: v.asnumpy() for n, v in mod.get_params()[0].items()}


@contextlib.contextmanager
def box_branch_cut():
    """The port's ``smooth_l1`` on a detached input: no gradient reaches
    the box heads or the trunk from the box loss."""
    op = tmx.ops.registry.get_op("smooth_l1")
    fc = op.fcompute
    op.fcompute = lambda attrs, x: fc(attrs, x.detach())
    try:
        yield
    finally:
        op.fcompute = fc


def run(pkg, params, data, label, steps):
    mod = module(pkg, data, label)
    mod.init_params(arg_params=params, aux_params={})
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(OPT))
    with pkg.cpu():
        batch = pkg.io.DataBatch([pkg.nd.array(data)], [pkg.nd.array(label)])
    parts, first = [], None
    for step in range(steps + 1):
        mod.forward_backward(batch)
        ce, box, loc = objective([o.asnumpy() for o in mod.get_outputs()])
        parts.append((ce, box))
        if first is None:
            first = loc
        mod.update()
    matched = first != 0
    fell = float((loc[matched] < first[matched]).mean())
    return parts, fell


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    it = SyntheticDetIter(NUM_CLASSES, args.batch, (3, 300, 300), 1, seed=26)
    with tmx.cpu():
        b = next(iter(it))
    data, label = b.data[0].asnumpy(), b.label[0].asnumpy()
    params = initial_params(data, label)
    out = {"batch": args.batch, "steps": args.steps,
           "conv1_1_weight_abs_sum": float(np.abs(
               params["conv1_1_weight"]).sum(dtype=np.float64))}
    for name, pkg in (("reference", jmx), ("port", tmx),
                      ("port_box_branch_cut", tmx)):
        tic = time.perf_counter()
        with box_branch_cut() if name.endswith("cut") else \
                contextlib.nullcontext():
            parts, fell = run(pkg, params, data, label, args.steps)
        out[name] = {"class": [p[0] for p in parts],
                     "box": [p[1] for p in parts], "box_fell_share": fell}
        for step, (ce, box) in enumerate(parts):
            print("%s step %2d: class %.6f box %.6f" % (name, step, ce, box))
        print("%s: %d steps in %.1f s; box part %.6f -> %.6f, class part "
              "%.6f -> %.6f; matched coordinates whose smooth-L1 fell %.4f"
              % (name, args.steps, time.perf_counter() - tic, parts[0][1],
                 parts[-1][1], parts[0][0], parts[-1][0], fell))
    gap = max(abs(a - b) / abs(b) for k in ("class", "box")
              for a, b in zip(out["port"][k], out["reference"][k]))
    out["port_vs_reference"] = gap
    print("port vs reference: largest gap of a part %.3e (relative)" % gap)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
