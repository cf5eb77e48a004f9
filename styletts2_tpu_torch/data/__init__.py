from .dataset import FilePathDataset, Collater, build_dataloader, UnreadableAudioError

__all__ = ["FilePathDataset", "Collater", "build_dataloader", "UnreadableAudioError"]
