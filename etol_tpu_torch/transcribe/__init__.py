"""VGP -> NLP transcription: collocation, obstacles, assembly."""

from . import collocation, obstacles
from .nlp import NLP

__all__ = ["collocation", "obstacles", "NLP"]
