"""Post (``post/``): the filters, dedup and SRT, and the word segmentation."""

LAYER = "post (post/)"
WRAPS = [
    ("vse_tpu_torch.pipeline.extractor", "SubtitleExtractor.apply_filters", "post"),
    ("vse_tpu_torch.pipeline.extractor", "SubtitleExtractor.generate_subtitle_file", "post"),
    ("vse_tpu_torch.pipeline.extractor", "reformat_execute", "post"),
]
