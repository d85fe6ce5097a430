"""A tiny configuration of the flagship's family and small mixes, for
the benchmark's CPU tests: the cell's shapes cut to what a CPU test
holds."""

import copy

from port_bench.harness import bench

_ENC = {"input_layer": "conv2d", "pos_enc_layer_type": "rel_pos",
        "normalize_before": True, "macaron_style": True,
        "use_cnn_module": True, "cnn_module_kernel": 15, "causal": False,
        "cnn_module_norm": "batch_norm"}
# float32 against float32 at the tiny sizes
LIMITS = {"rel_err": 1e-3, "gap_mean": 1e-3, "gap_max": 1e-2,
          "flip_share": 0.01}


def flagship_model():
    return {"nnet_proto": "conformer_aed_fmoe_localComm_catEmbed_domain_acc_hier",
            "input_dim": 40, "output_dim": 50, "model_conf": {"encoder_conf": {
                "attention_heads": 4, "attention_dim": 32, "num_blocks": 2,
                **_ENC,
                "embed_conf": {"attention_heads": 2, "attention_dim": 32,
                               "linear_units": 64, "num_blocks": 1, **_ENC},
                "moe_conf": {"num_experts": 4, "hidden_units": 64,
                             "router_with_bias": False}}}}


def config(name, dtype="float32"):
    """The named configuration's file with its model cut to the tiny
    one."""
    cfg = copy.deepcopy(bench.config(name))
    cfg["model"] = flagship_model()
    cfg["engine"]["dtype"] = dtype
    cfg["engine"]["attn_impl"] = "xla"
    return cfg


def mix(name):
    m = copy.deepcopy(bench.mix(name))
    m.update(corpus=64, shard=16, batch=4)
    m["lengths"].update(max=min(m["lengths"]["max"], 400),
                        min=min(m["lengths"]["min"], 300))
    m["check"].update(sample=3, batches=1)
    return m
