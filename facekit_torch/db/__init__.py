from facekit_torch.db.database import Database  # noqa: F401
