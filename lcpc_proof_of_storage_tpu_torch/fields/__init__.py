"""Field specs of the reference, reused as they are (``fields/field.py`` of
``lcpc_proof_of_storage_tpu`` imports no JAX), so callers of the port need
not import the reference package themselves."""

from lcpc_proof_of_storage_tpu.fields.field import (FIELDS, FT63, FT127, FT191, FT253_192,
                                                    FT255, FieldSpec, ints_to_limbs,
                                                    limbs_to_ints)

__all__ = ["FIELDS", "FT63", "FT127", "FT191", "FT253_192", "FT255", "FieldSpec",
           "ints_to_limbs", "limbs_to_ints"]
