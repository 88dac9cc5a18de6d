"""The model the fbank frontend feeds (port of ``lhotse_tpu/models``)."""
from lhotse_tpu_torch.models.encoder import (
    Encoder, EncoderConfig, draw_mask, forward, init_params, make_adamw_train_step,
    masked_prediction_loss, param_shardings, sgd_train_step)

__all__ = [
    "Encoder", "EncoderConfig", "draw_mask", "forward", "init_params", "make_adamw_train_step",
    "masked_prediction_loss", "param_shardings", "sgd_train_step"]
