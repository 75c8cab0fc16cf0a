"""Default configuration (a copy of ``accel_tpu/config/defaults.py``).

The field vocabulary is the reference's (``network``, ``dataset``,
``TRAIN``, ``TEST``, ``SCALES``, ``PIXEL_MEANS`` ...), so every experiment
YAML of ``experiments/cfgs/`` merges strictly onto it, ``tpu.*`` included:
the port reads ``tpu.mesh`` (``parallel/mesh.py``: ``data`` -1 or the
number of ranks, ``spatial`` 1) and keeps the other ``tpu`` keys so that a
reference YAML that sets them still loads.
"""

from accel_tpu_torch.config.loader import Config


def make_defaults() -> Config:
    return Config(
        {
            "MXNET_VERSION": "",  # kept for YAML compatibility; ignored
            "output_path": "./output",
            "symbol": "",
            "gpus": "0",
            "CLASS_AGNOSTIC": True,
            "SCALES": [[1024, 2048]],  # (short side, max size)
            "default": {"frequent": 20, "kvstore": "device"},
            "network": {
                "name": "accel",  # deeplab | dff | accel
                "ref_depth": 101,  # keyframe branch
                "update_depth": 18,  # accel update branch
                "pretrained": "",
                "pretrained_flow": "",
                "pretrained_update": "",
                "pretrained_epoch": 0,
                "PIXEL_MEANS": [103.06, 115.90, 123.15],  # BGR
                "PIXEL_STDS": [1.0, 1.0, 1.0],
                "IMAGE_STRIDE": 0,
                "FIXED_PARAMS": [],
                "feat_stride": 16,
                "head_dilation": 6,
                "head_channels": 1024,
                "flow_input_downscale": 2,
                # incremental | direct | composed (core/pipeline.py)
                "propagate": "incremental",
                "use_scale_field": True,
                # last | product | mean1 | clamp (core/pipeline.py)
                "scale_cascade": "last",
                # mean1 | none: the scale field renormalized to mean 1 per
                # sample, or raw (reference-weight parity)
                "scale_field_norm": "mean1",
                "quantize_ref": False,
                "quantize_update": False,
                # frozenbn (pretrained stats) | groupnorm (from scratch)
                "norm": "groupnorm",
                "dtype": "bfloat16",
                "use_pallas_warp": True,
                # the warp's static displacement clamp, feature pixels
                "warp_max_disp": 8,
                "warp_dtype": "f32",  # f32 | native
                "warp_gather": "taps",  # taps | stacked | onehot
                # 0 = the reference branch's stride / fc6 width
                "update_feat_stride": 0,
                "update_head_channels": 0,
                "flow_width_mult": 1.0,
                "update_input_downscale": 1,
                "fold_update_downscale": False,
                "fold_flow_downscale": False,
                "stem": "conv7",  # conv7 | fused7 (frozenbn only) | s2d
            },
            "dataset": {
                "dataset": "CityScape",
                "dataset_path": "./data/cityscapes",
                "image_set": "leftImg8bit_train",
                "test_image_set": "leftImg8bit_val",
                "root_path": "./data",
                "NUM_CLASSES": 19,
                "annotation_prefix": "gtFine",
            },
            "TRAIN": {
                "lr": 0.0005,
                "lr_step": "3.333",  # epochs at which lr decays (csv)
                "lr_factor": 0.1,
                "warmup": True,
                "warmup_lr": 0.00005,
                "warmup_step": 1000,
                "momentum": 0.9,
                "wd": 0.0005,
                "begin_epoch": 0,
                "end_epoch": 5,
                "model_prefix": "accel",
                "RESUME": False,
                "FLIP": True,
                "SHUFFLE": True,
                "BATCH_IMAGES": 1,
                "MIN_OFFSET": -4,
                "MAX_OFFSET": 0,
                "CROP_SIZE": [768, 768],
                "loss_scale": 1.0,
                "grad_clip": 0.0,
                "checkpoint_interval": 1,
                "ohem_fraction": 0.0,
                "aux_loss_weight": 0.5,
                "objective": "clip",  # clip | pair
                "remat": True,
                "CLIP_LENGTH": 5,
            },
            "TEST": {
                "BATCH_IMAGES": 1,
                "KEY_FRAME_INTERVAL": 5,
                # the annotated frame's offset before the clip's end
                "KEY_FRAME_OFFSET": 0,
                "max_per_image": 300,
                "test_epoch": 5,
                # bilinear_logits (reference protocol) | nearest_pred
                "upsample": "bilinear_logits",
                # network.* overrides that the eval entry point applies
                # (serving lowerings); --set-network wins over them
                "serving_network": None,
            },
            # the reference's TPU knobs; the port reads only mesh (parallel/mesh.py)
            "tpu": {
                "mesh": {"data": -1, "spatial": 1},
                "donate_carry": True,
                "profile": False,
                "prefetch_depth": 2,
            },
        }
    )
