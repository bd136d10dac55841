from facekit_torch.pipeline.recognize import FacePipeline  # noqa: F401
