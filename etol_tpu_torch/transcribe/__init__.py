"""Transcription: collocation defects, obstacle constraints, NLP."""
