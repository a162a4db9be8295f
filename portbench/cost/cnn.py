"""The paper's CNN (Fig. 3, Table II) counted from its shapes: parameters,
operations an image, and a seed-round's required work."""
import math


def shapes(m: dict) -> dict:
    """``{name: shape}`` of one model in the port's layout (HWIO conv
    weights, ``[din, dout]`` linear weights), from the config's ``model``."""
    k, cin = m["kernel"], m["input_channels"]
    c1, c2, fc1, out = m["conv1_out"], m["conv2_out"], m["fc1_out"], \
        m["num_classes"]
    h, w = m["input_hw"]
    for _ in range(2):
        h, w = (h - k + 1) // m["pool"], (w - k + 1) // m["pool"]
    return {"w_c1": (k, k, cin, c1), "b_c1": (c1,),
            "w_c2": (k, k, c1, c2), "b_c2": (c2,),
            "w_fc1": (h * w * c2, fc1), "b_fc1": (fc1,),
            "w_fc2": (fc1, out), "b_fc2": (out,)}


def param_count(m: dict) -> int:
    return sum(math.prod(s) for s in shapes(m).values())


def forward_flops(m: dict) -> int:
    """One image's forward: two flops a multiply-add of the two VALID
    convolutions and the two linear layers, one a bias add (pools and
    ReLUs compare, and are not counted)."""
    k, p = m["kernel"], m["pool"]
    h, w = m["input_hw"]
    flops, cin = 0, m["input_channels"]
    for cout in (m["conv1_out"], m["conv2_out"]):
        h, w = h - k + 1, w - k + 1
        flops += h * w * cout * (2 * k * k * cin + 1)
        h, w, cin = h // p, w // p, cout
    for din, dout in ((h * w * cin, m["fc1_out"]),
                      (m["fc1_out"], m["num_classes"])):
        flops += dout * (2 * din + 1)
    return flops


def train_flops(m: dict) -> int:
    """One training image's forward and backward: three forwards (the
    backward takes the gradients of the inputs and of the weights)."""
    return 3 * forward_flops(m)


def seed_round(config: dict):
    """``(flops, bytes)`` one seed's selection round needs: local SGD of S
    clients (L steps of a batch each), the test set's forward; the plane
    read once for the divergence, the clients' shards and the test set
    read once, the S trained rows and the new global row written once."""
    m, fl = config["model"], config["fl"]
    p = param_count(m)
    image = math.prod(m["input_hw"]) * m["input_channels"] * 4
    s = fl["devices_per_round"]
    flops = (s * fl["local_iters"] * fl["batch_size"] * train_flops(m)
             + fl["test_samples"] * forward_flops(m))
    nbytes = (fl["clients"] * p * 4 + p * 4
              + s * fl["samples_per_client"] * (image + 4)
              + fl["test_samples"] * (image + 4)
              + s * p * 4 + p * 4)
    return flops, nbytes
