from facekit_torch.server.app import FaceServer, make_app  # noqa: F401
