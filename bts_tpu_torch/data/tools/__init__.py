"""Dataset tools (download lists, NYU extraction, split manifests): copies of
``bts_tpu.data.tools``, host only."""
