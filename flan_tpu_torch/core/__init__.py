"""Containers: AudioBuffer and PVBuffer."""
