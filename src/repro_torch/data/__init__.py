from repro_torch.data.pipeline import SyntheticPipeline, batch_to, make_pipeline

__all__ = ["SyntheticPipeline", "batch_to", "make_pipeline"]
