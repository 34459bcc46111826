"""The persistent bucket index and batched query serving."""
