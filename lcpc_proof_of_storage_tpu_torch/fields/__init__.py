"""Field specs (``field``) and limb arithmetic on tensors (``limb``)."""

from .field import (FIELDS, FT63, FT127, FT191, FT253_192, FT255, WRITEABLE_FT63, FieldSpec,
                    ints_to_limbs, limbs_to_ints)

__all__ = ["FIELDS", "FT63", "FT127", "FT191", "FT253_192", "FT255", "WRITEABLE_FT63",
           "FieldSpec", "ints_to_limbs", "limbs_to_ints"]
