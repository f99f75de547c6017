"""Proposal and detection layers."""
