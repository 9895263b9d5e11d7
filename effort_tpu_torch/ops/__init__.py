"""Bucketized weight format, effort selection and bucketMul math."""
