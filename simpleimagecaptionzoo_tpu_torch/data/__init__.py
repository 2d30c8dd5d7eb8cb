from simpleimagecaptionzoo_tpu_torch.data.caption_data import CaptionData  # noqa: F401
