"""Export of the deploy model: a torch.export program and an AOTInductor
package (export.py)."""
