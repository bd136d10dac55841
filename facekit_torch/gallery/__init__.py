from facekit_torch.gallery.store import GalleryStore, GallerySnapshot  # noqa: F401
