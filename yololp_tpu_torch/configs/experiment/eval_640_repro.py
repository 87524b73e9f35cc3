# eval reproduction params (reference: configs/experiment/eval_640_repro.py)
# per-model eval-time letterbox knobs; consumed by tools/eval.py overrides
eval_params = dict(
    default=dict(img_size=640, test_load_size=638, letterbox_return_int=True,
                 force_no_pad=True, not_infer_on_rect=True),
    yolov6n=dict(img_size=640, test_load_size=636, letterbox_return_int=True),
    yolov6s=dict(img_size=640, test_load_size=638, letterbox_return_int=True),
    yolov6m=dict(img_size=640, test_load_size=636, letterbox_return_int=True),
    yolov6l=dict(img_size=640, test_load_size=636, letterbox_return_int=True),
)
