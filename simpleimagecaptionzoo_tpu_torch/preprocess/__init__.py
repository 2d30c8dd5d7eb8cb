"""The port's preprocessing entry points, each run with ``python -m``
and the JAX package's flags (the JAX package's ``preprocess/``):
``datasets_json_modification`` (raw annotations to the modified
annotations), ``build_caption_vocab``, ``cider_idf_preprocess`` (the
CIDEr-D idf pickle and the device table), ``generate_bottom_up_features``
(bottom-up TSVs to per-image arrays and a packed shard) and
``pack_images`` (a packed uint8 image shard).  They write the same files
as the JAX package's scripts, and import neither JAX nor that package."""
