from yololp_tpu_torch.quant.quantize import (
    calibrate,
    compute_amax,
    fake_quant,
    load_amax,
    quantize_weights,
    quantized_apply,
    save_amax,
)
