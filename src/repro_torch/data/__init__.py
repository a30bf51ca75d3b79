from repro_torch.data.pipeline import (DataPipeline, FramesPipeline,
                                       PipelineState)

__all__ = ["DataPipeline", "FramesPipeline", "PipelineState"]
