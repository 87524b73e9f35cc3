# yolov6n with in-config eval params (reference:
# configs/experiment/yolov6n_with_eval_params.py): demonstrates the
# eval_params override block — list-valued entries mean
# [train-time value, eval-time value] (consumed by tools/eval.py and the
# Trainer's in-loop eval, same convention as the reference).
model = dict(
    type="YOLOv6n",
    pretrained=None,
    depth_multiple=0.33,
    width_multiple=0.25,
    backbone=dict(
        type="EfficientRep",
        num_repeats=[1, 6, 12, 18, 6],
        out_channels=[64, 128, 256, 512, 1024],
    ),
    neck=dict(
        type="RepPANNeck",
        num_repeats=[12, 12, 12, 12],
        out_channels=[256, 128, 128, 256, 256, 512],
    ),
    head=dict(
        type="EffiDeHead",
        in_channels=[128, 256, 512],
        num_layers=3,
        begin_indices=24,
        anchors=1,
        out_indices=[17, 20, 23],
        strides=[8, 16, 32],
        iou_type="siou",
        use_dfl=False,
        reg_max=0,
    ),
)

solver = dict(
    optim="SGD",
    lr_scheduler="Cosine",
    lr0=0.02,
    lrf=0.01,
    momentum=0.937,
    weight_decay=0.0005,
    warmup_epochs=3.0,
    warmup_momentum=0.8,
    warmup_bias_lr=0.1,
)

data_aug = dict(
    hsv_h=0.015,
    hsv_s=0.7,
    hsv_v=0.4,
    degrees=0.0,
    translate=0.1,
    scale=0.5,
    shear=0.0,
    flipud=0.0,
    fliplr=0.5,
    mosaic=1.0,
    mixup=0.0,
)

training_mode = "repvgg"

# Eval params used when evaluating during training / via tools/eval.py.
# None means "inherit the CLI/train value"; a 2-list means
# [used by tools/train.py in-loop eval, used by tools/eval.py].
eval_params = dict(
    batch_size=None,
    img_size=None,
    conf_thres=0.03,
    iou_thres=0.65,
    test_load_size=None,
    letterbox_return_int=False,
    force_no_pad=False,
    not_infer_on_rect=False,
    scale_exact=False,
    verbose=False,
    do_coco_metric=True,
    do_pr_metric=False,
    plot_curve=False,
    plot_confusion_matrix=False,
)
