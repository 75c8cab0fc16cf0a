"""The port's entry points (counterparts of ``experiments/*.py``), each run
as a module from the repository root, on the card unless given
``--device cpu``:

    # train from a cfg: checkpoints <output_path>/<cfg name>/<image_set>/<model_prefix>/<epoch>.pt
    python3 -m accel_tpu_torch.experiments.train --cfg experiments/cfgs/accel18_cityscapes.yaml
    # resume: set TRAIN.RESUME: true in the cfg (and a later TRAIN.end_epoch)
    # evaluate the newest checkpoint at or below TEST.test_epoch
    python3 -m accel_tpu_torch.experiments.test --cfg experiments/cfgs/accel18_cityscapes.yaml

``train.main(argv)`` returns the final train state, ``test.main(argv)`` one
result per interval and offset.
"""
